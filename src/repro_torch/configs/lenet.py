"""LeNet-5 on MNIST — the PAPER'S OWN correlation workload (§IV).

Not part of the assigned 10-arch pool; registered so the simulator benchmarks
(`benchmarks/correlation.py`, `benchmarks/power_breakdown.py`) can reproduce the
paper's Fig. 6-8 experiments end-to-end.  The conv layers can be lowered with any
of the cuDNN-analogue algorithms in ``repro_torch.models.conv_algos``.
"""
from repro_torch.config import ArchEntry, ModelConfig, register

FULL = ModelConfig(
    name="lenet",
    family="conv",
    num_layers=2,
    d_model=0,
    conv_channels=(6, 16),
    conv_kernel=5,
    fc_dims=(120, 84),
    image_hw=28,
    image_c=1,
    num_classes=10,
    dtype="float32",           # paper correlates the FP32 build
)

SMOKE = ModelConfig(
    name="lenet-smoke",
    family="conv",
    num_layers=2,
    d_model=0,
    conv_channels=(2, 4),
    conv_kernel=3,
    fc_dims=(16, 12),
    image_hw=12,
    image_c=1,
    num_classes=10,
    dtype="float32",
)

register(ArchEntry(
    arch_id="lenet",
    full=FULL,
    smoke=SMOKE,
    source="LeCun et al. 1998; paper §IV workload",
    shape_skips=(
        ("train_4k", "CNN workload: uses its own (28x28) image shapes, not token shapes"),
        ("prefill_32k", "CNN workload: no sequence dimension"),
        ("decode_32k", "CNN workload: no autoregressive decode"),
        ("long_500k", "CNN workload: no sequence dimension"),
    ),
))
