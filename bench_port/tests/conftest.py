"""Fixtures of the benchmark's tests: small copies of the cells' files."""

from __future__ import annotations

import pytest
import torch

from bench_port import spec


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def bench():
    return spec.load_benchmark()


def small_config(bench: dict, name: str) -> dict:
    """The configuration with its scene cut by its own
    ``scenes/<kind>.py`` ``small`` to a size the CPU renders and converts
    in seconds; the store settings stay as they are."""
    cfg = spec.config(bench, name)
    cfg["scene"] = spec.scene(cfg["scene"]["kind"]).small(cfg["scene"])
    return cfg


def small_mix(bench: dict, workload: str) -> dict:
    mix = spec.traffic(spec.cell(bench, workload)["traffic"])
    mix.update(width=160, height=96, check_every=2)
    return mix
