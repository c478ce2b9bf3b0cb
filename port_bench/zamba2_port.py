"""What the benchmark takes from the program for the published Zamba2: its
model configuration (``repro_torch.config.Zamba2Config``, family
``zamba2``) and the layout its parameters must have; the kernels' build and
the device's bookkeeping are :mod:`port`'s.  Every import of the program is
inside a function."""
from __future__ import annotations

from typing import Mapping

from port import build_kernels, free, memory_peak, sync  # noqa: F401  (the loop's)
import weights as W

#: the published keys whose values the program's zamba2 model takes as
#: given (it has no switch for another value)
FIXED = {"hidden_act": "gelu", "add_bias_linear": False, "use_conv_bias": True,
         "use_mem_rope": True, "use_long_context": False, "use_shared_mlp_adapter": True,
         "use_shared_attention_adapter": False, "time_step_limit": None, "mamba_headdim": 64}


def model_config(cfg: Mapping):
    """The port's ``Zamba2Config`` of a configuration file (the published
    keys, as the file holds them); raises where the file asks for what the
    program does not implement."""
    from repro_torch.config import Zamba2Config
    wrong = {k: cfg.get(k) for k, v in FIXED.items() if cfg.get(k) != v}
    d = cfg["hidden_size"]
    if (cfg["attention_hidden_size"] != 2 * d
            or cfg["n_mamba_heads"] * cfg["mamba_headdim"] != cfg["mamba_expand"] * d):
        wrong["widths"] = (cfg["attention_hidden_size"], cfg["n_mamba_heads"])
    if wrong:
        raise ValueError(f"the program's zamba2 model does not take {wrong}")
    return Zamba2Config(
        name=cfg["name"], family="zamba2", num_layers=cfg["num_hidden_layers"], d_model=d,
        num_heads=cfg["num_attention_heads"], num_kv_heads=cfg["num_key_value_heads"],
        head_dim=cfg["attention_head_dim"], d_ff=cfg["intermediate_size"],
        vocab_size=cfg["vocab_size"], ssm_state=cfg["mamba_d_state"],
        ssm_expand=cfg["mamba_expand"], ssm_conv=cfg["mamba_d_conv"],
        ssm_ngroups=cfg["mamba_ngroups"], ssm_chunk=cfg["chunk_size"],
        hybrid_layers=tuple(cfg["hybrid_layer_ids"]), shared_blocks=cfg["num_mem_blocks"],
        adapter_rank=cfg["adapter_rank"], rope_theta=float(cfg["rope_theta"]),
        norm_eps=cfg["rms_norm_eps"], tie_embeddings=bool(cfg["tie_word_embeddings"]),
        dtype=cfg["torch_dtype"])


def check_layout(model_cfg, params: Mapping) -> None:
    """Raise unless the benchmark's tree is the port's, leaf for leaf."""
    from repro_torch.models import build_model
    want = W.shapes_of(build_model(model_cfg).abstract())
    got = W.shapes_of(params)
    if want != got:
        diff = sorted(set(want.items()) ^ set(got.items()))
        raise ValueError(f"the benchmark's weights are not the port's tree: {diff[:6]}")
