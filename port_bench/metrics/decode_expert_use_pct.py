"""The experts a traced decode step used: the experts with a filled slot
(a token of the batch routed to them) over the experts whose weights the
step reads, every layer's, over the decode steps made while the profiler
recorded (the program's ``moe_experts_filled_total`` and
``moe_experts_read_total`` counters, ``step=decode``); a program that
counts nothing gives nothing."""


def read(run):
    try:
        from repro_torch.obs.metrics import REGISTRY
    except ImportError:
        return None
    read_ = REGISTRY.value("moe_experts_read_total", step="decode")
    if not read_:
        return None
    return 100.0 * REGISTRY.value("moe_experts_filled_total", step="decode") / read_
