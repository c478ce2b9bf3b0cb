"""The share of the traced prefills' Mamba2 mixers that took the two
hand-written mixer kernels (the conv, SiLU and dt before the scan; the skip,
gate and grouped norm after it): the program's
``ssm_mixer_kernel_layers_total`` over its ``ssm_mixer_layers_total``,
``step=prefill``.  Where the program never recorded the first (one without
the kernels), or counts no mixer layers, it gives nothing."""


def read(run):
    try:
        from repro_torch.obs.metrics import REGISTRY
    except ImportError:
        return None
    kernel = REGISTRY.get("ssm_mixer_kernel_layers_total", step="prefill")
    layers = REGISTRY.value("ssm_mixer_layers_total", step="prefill")
    if kernel is None or not layers:
        return None
    return 100.0 * kernel.value / layers
