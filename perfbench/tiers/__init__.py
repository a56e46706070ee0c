"""One module a model kind, found by the ``kind`` a configuration's tier
names (``perfbench/tiers/<kind>.py``).  Each gives:

``leaves(cfg)``            the benchmark's own weights: ``{name: (shape,
                           std)}`` in the program's names and layouts, a
                           float ``std`` drawn from a normal, ``"one"`` or
                           ``"zero"`` a constant;
``port(cfg, device)``      the program's model, empty, to be loaded;
``reference(cfg)``         ``f(state, images)``, the plain forward;
``kernels(cfg)``           ``{kernel name part: launches a call}`` of the
                           program's hand-written kernels;
``attention_calls(cfg, n)`` the (B, Sq, Sk, H, D) of each flash-attention
                           call a batch of ``n`` frames makes.
"""
from __future__ import annotations

import importlib


def tier_module(kind: str):
    return importlib.import_module(f"perfbench.tiers.{kind}")
