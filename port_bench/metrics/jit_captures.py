"""The CUDA graphs the run captured, set-up included (the program's
``jit_captures_total`` counter at the run's end); a program that counts no
captures gives nothing."""


def read(run):
    try:
        from repro_torch.obs.metrics import REGISTRY
    except ImportError:
        return None
    captures = REGISTRY.get("jit_captures_total")
    return None if captures is None else captures.value
