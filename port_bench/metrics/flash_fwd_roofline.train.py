"""The flash-attention forward kernel's share of its roofline in the
traced training steps (each layer's forward and its recompute): the
yardstick's bound of one call at the step's shape (causal), times the calls
the trace holds, over their summed device time."""
import weights as W
import yardstick as Y

KERNEL = "attn_wgmma_kernel"


def read(run):
    trace = run.tracer.trace if run.tracer is not None else None
    times = trace.kernels(KERNEL, "step") if trace is not None else []
    if not times:
        return None
    cfg, tr = run.config, run.traffic
    s = tr["seq_len"]
    bound = Y.flash_fwd_bound_s(tr["batch"], cfg["num_attention_heads"],
                                cfg["num_key_value_heads"], s, s, W.head_dim(cfg))
    return 100.0 * bound * len(times) / (sum(times) / 1e9)
