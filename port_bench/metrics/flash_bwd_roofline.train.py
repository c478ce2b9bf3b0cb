"""The flash-attention backward's share of its roofline in the traced
training steps: the yardstick's bound of one backward at the step's shape
(causal; two products per forward product, no recompute, and twice the
forward's bytes), times the calls the trace holds (one ``flash_bwd_dkdv``
kernel a call), over the summed device time of every ``flash_bwd_`` kernel
in the phase.  The same work whatever computes it; a trace with no such
kernel gives nothing."""
import weights as W
import yardstick as Y

KERNELS, CALL = "flash_bwd_", "flash_bwd_dkdv"


def read(run):
    trace = run.tracer.trace if run.tracer is not None else None
    times = trace.kernels(KERNELS, "step") if trace is not None else []
    calls = len(trace.kernels(CALL, "step")) if times else 0
    if not calls:
        return None
    cfg, tr = run.config, run.traffic
    b, s, d = tr["batch"], tr["seq_len"], W.head_dim(cfg)
    h, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    bound = Y.bound_s(2 * Y.attn_flops(b, h, s, s, d, True),
                      2 * Y.flash_fwd_bytes(b, h, kv, s, s, d))
    return 100.0 * bound * calls / (sum(times) / 1e9)
