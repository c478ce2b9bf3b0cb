"""The flash-attention forward's share of its roofline at head dim 224 in
the traced prefills: the yardstick's bound of one call at the prefill's
shape (causal, h = kv heads, d 224: the work any implementation must do,
not the padded 256 the kernel computes), times the calls of the d-224
instances (``attn_wgmma_kernel<..., 224, ...>``) in the whole prefill
replays (``zamba2_trace.py``), over their summed device time."""
import yardstick as Y
import zamba2_trace as ZT

KERNEL = "attn_wgmma_kernel"
INSTANCE = ", 224,"


def read(run):
    got = ZT.prefill_replays(run)
    times = [e - s for rp in (got[1] if got else []) for name, s, e in rp.events
             if KERNEL in name and INSTANCE in name]
    if not times:
        return None
    cfg, tr = run.config, run.traffic
    s = tr["prompt_len"]
    bound = Y.flash_fwd_bound_s(tr["batch"], cfg["num_attention_heads"],
                                cfg["num_key_value_heads"], s, s, cfg["attention_head_dim"])
    return 100.0 * bound * len(times) / (sum(times) / 1e9)
