"""The benchmark's inputs: clouds from a seed, decoded as the program's
readers decode the files users convert.

A configuration's ``scene["kind"]`` names the module ``scenes/<kind>.py``
that draws its inputs; it provides ``fields(scene, seed, index, device)``
(the fields of input ``index`` as its file holds them), ``decoded(scene,
fields)`` (positions f32 (N, 3) and colours rgba u8 (N, 4) as the port's
reader of that format decodes them), ``points(scene)`` (the points of an
input) and ``small(scene)`` (the scene cut to a size the CPU tests run in
seconds, the store settings untouched). Every size comes from the
configuration's file and every choice of the run from the traffic mix's
file; a seed changes where things are, never how many. A point's colour
is a function of its position, so two returns at one position carry one
colour. A scene draws from the streams below.
"""

from __future__ import annotations

import numpy as np

from . import spec


def rng_for(seed: int, *path: int) -> np.random.Generator:
    """An independent NumPy stream for ``path`` under ``seed`` (any whole
    number): the scene's layout, the same on every device."""
    return np.random.default_rng(
        np.random.SeedSequence([seed & (2**64 - 1), *path]))


class Draws:
    """Bulk per-point draws on ``device`` from a ``torch.Generator`` seeded
    by ``path`` under ``seed``: the same numbers for the same seed on the
    same kind of device."""

    def __init__(self, seed: int, path: tuple, device):
        import torch

        state = np.random.SeedSequence(
            [seed & (2**64 - 1), *path]).generate_state(2, np.uint32)
        self.torch = torch
        self.device = device
        self.g = torch.Generator(device=device)
        self.g.manual_seed((int(state[0]) << 31) ^ int(state[1]))

    def uniform(self, lo, hi, n):
        t = self.torch
        u = t.rand(n, generator=self.g, device=self.device, dtype=t.float64)
        return u * (hi - lo) + lo

    def normal(self, sd, n):
        t = self.torch
        return t.randn(n, generator=self.g, device=self.device,
                       dtype=t.float64) * sd

    def choice(self, weights: np.ndarray, n: int):
        t = self.torch
        w = t.as_tensor(weights, dtype=t.float64, device=self.device)
        return t.multinomial(w, n, replacement=True, generator=self.g)

    def integers(self, k: int, n: int):
        t = self.torch
        return t.randint(k, (n,), generator=self.g, device=self.device)

    def permutation(self, n: int):
        return self.torch.randperm(n, generator=self.g, device=self.device)

    def take(self, values: np.ndarray, index):
        t = self.torch
        return t.as_tensor(values, device=self.device)[index]


def input_fields(scene: dict, seed: int, index: int, device="cpu") -> dict:
    """Input ``index`` of the configuration's scene, drawn on ``device``:
    the fields its file holds."""
    return spec.scene(scene["kind"]).fields(scene, seed, index, device)


def decoded(scene: dict, fields: dict):
    """(positions f32, colours rgba u8) as the program's reader decodes
    the input's file."""
    return spec.scene(scene["kind"]).decoded(scene, fields)


def decoded_inputs(scene: dict, seed: int, indices, device="cpu"):
    """:func:`decoded` of several inputs, concatenated in the given
    order."""
    parts = [decoded(scene, input_fields(scene, seed, int(i), device))
             for i in indices]
    return (np.concatenate([p for p, _ in parts]),
            np.concatenate([c for _, c in parts]))


def input_points(scene: dict) -> int:
    """Points of one input."""
    return spec.scene(scene["kind"]).points(scene)
