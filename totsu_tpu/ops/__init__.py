"""Compute primitives: packed-symmetric storage, PSD projection."""

from totsu_tpu.ops import sympack
