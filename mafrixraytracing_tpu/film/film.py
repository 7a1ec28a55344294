"""Progressive film accumulation.

Functional version of the reference `Film` (`Core/Film.fs:13-36`): running
radiance sum + frame count; the display frame is `sum / count`. The state is
a pytree, so it is (a) jit-carriable, (b) exactly the resumable-render
checkpoint the reference implicitly had (SURVEY §5) — persisting
`FilmState` + the RNG root key + next sample index resumes a render
bit-exactly (see `utils.checkpoint`).
"""
from __future__ import annotations

import jax.numpy as jnp
from mafrixraytracing_tpu.core import struct
from jax import Array

from mafrixraytracing_tpu.film import tonemap as tm


class FilmState(struct.PyTreeNode):
    radiance_sum: Array   # (H, W, 3) running sum of per-frame radiance
    frame_count: Array    # () i32

    @classmethod
    def create(cls, height: int, width: int) -> "FilmState":
        return cls(
            radiance_sum=jnp.zeros((height, width, 3), jnp.float32),
            frame_count=jnp.zeros((), jnp.int32),
        )

    def add_frame(self, frame: Array) -> "FilmState":
        """Accumulate one frame of per-pixel radiance
        (reference `Film.AddSample`, `Film.fs:18-23`)."""
        return self.replace(
            radiance_sum=self.radiance_sum + frame,
            frame_count=self.frame_count + 1,
        )

    def reset(self) -> "FilmState":
        """(reference `Film.Reset`, `Film.fs:26-30`)"""
        return FilmState.create(*self.radiance_sum.shape[:2])

    @property
    def mean(self) -> Array:
        n = jnp.maximum(self.frame_count, 1)
        return self.radiance_sum / n

    def display(self) -> Array:
        """Tonemapped [0,1] image (ACES + gamma, reference
        `Scene.fs:315-330`)."""
        return tm.tonemap(self.mean)

    def to_bytes(self) -> Array:
        return tm.to_bytes(self.display())
