"""The share of the traced prefills' SSD scan chunks that the hand-written
scan kernel covered: the program's ``ssm_scan_kernel_chunks_total`` over its
``ssm_scan_chunks_total``, ``step=prefill``.  Where the program never
recorded the first (one without the kernel), or counts no scan chunks, it
gives nothing."""


def read(run):
    try:
        from repro_torch.obs.metrics import REGISTRY
    except ImportError:
        return None
    kernel = REGISTRY.get("ssm_scan_kernel_chunks_total", step="prefill")
    chunks = REGISTRY.value("ssm_scan_chunks_total", step="prefill")
    if kernel is None or not chunks:
        return None
    return 100.0 * kernel.value / chunks
