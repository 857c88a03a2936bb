"""Global numeric constants shared by the tracer (counterpart of
`mcpt_tpu/constants.py`, same values).

Mirrors the reference's `src/global.hpp` / `src/Renderer.cpp:15` constants and
`src/WaveLen.hpp:7-18` CIE-1931 wavelengths (micrometers).
"""

import numpy as np

# Geometric tolerance used for self-intersection offsets, Dirac half-vector
# tests and the shadow-distance margin (reference: Renderer.cpp:15).
EPSILON = 1e-4

# f32 scale guard for the shadow epsilons: effective epsilon =
# max(EPSILON, REL_EPS * scale), ~34 f32 ULPs of the quantity.
REL_EPS = 4e-6

# Firefly clamps applied per path vertex (reference: Scene.cpp:180-182).
CLAMP_INDIRECT = 5.0
CLAMP_DIRECT = 15.0

# Sentinel "miss" distance (a large finite float32).
T_MAX = np.float32(3.0e37)

# Entries of the kernels' BVH walk stacks (csrc/mega_common.cuh kStack): a
# walk pushes at most one entry per tree level, so a tree of more levels
# takes the deep instances.
BVH_STACK = 32

# K3's deep walk's two-tier stack (csrc/deep_stack.cuh kTier, kRun): the
# top DEEP_TIER entries stay in shared memory, the rest go to the ray's
# area of device memory DEEP_RUN at a time.
DEEP_TIER = 8
DEEP_RUN = 4


def spill_entries(depth):
    """Entries of a ray's device area for a tree of `depth` levels
    (csrc/deep_stack.cuh `spill_entries`): those past the tier, in whole
    runs."""
    return -(-(depth - DEEP_TIER) // DEEP_RUN) * DEEP_RUN if depth > DEEP_TIER else 0

# The three traced wavelengths in micrometers, CIE 1931 primaries
# (reference: WaveLen.hpp:7-18). Channel order is R, G, B.
WAVELEN_UM = np.array([0.700, 0.5461, 0.4358], dtype=np.float32)

# Output transfer curve (reference: Renderer.cpp:96).
INV_GAMMA = 0.45
