"""gsplat "classic" compositing constants, shared by the tile rasterizer and
the compositing kernels (port of the constants of
``sim_a_splat_tpu/ops/rasterize_reference.py``; the dense golden renderer
itself is not part of this slice)."""

ALPHA_CLAMP = 0.999      # max per-gaussian alpha
ALPHA_MIN = 1.0 / 255.0  # contributions below this are dropped
