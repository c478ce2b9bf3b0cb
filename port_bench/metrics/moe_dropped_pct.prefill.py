"""The choices the traced prefills dropped past their expert's capacity,
over the choices routed (the program's ``moe_choices_dropped_total`` and
``moe_choices_routed_total`` counters, ``step=prefill``); a program that
counts nothing gives nothing."""


def read(run):
    try:
        from repro_torch.obs.metrics import REGISTRY
    except ImportError:
        return None
    routed = REGISTRY.value("moe_choices_routed_total", step="prefill")
    if not routed:
        return None
    return 100.0 * REGISTRY.value("moe_choices_dropped_total", step="prefill") / routed
