"""The closed serving loop of ``loops/serve.py``, run unchanged, for a
configuration with a program model, weights and a reference of its own (the
published Zamba2): ``serve.py`` is loaded as a module of its own here and
its ``port``, ``W`` and ``check`` are bound to :mod:`zamba2_port`,
:mod:`zamba2_weights` and :mod:`zamba2_check`.  Both serving loops are then
timed by the same lines."""
from __future__ import annotations

from pathlib import Path

import harness
import zamba2_check
import zamba2_port
import zamba2_weights

_SERVE = harness.load_module(Path(__file__).with_name("serve.py"), "port_bench_loop_serve_zamba2")
_SERVE.port, _SERVE.W, _SERVE.check = zamba2_port, zamba2_weights, zamba2_check
run = _SERVE.run
