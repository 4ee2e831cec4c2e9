"""Render configuration — the PyTorch counterpart of gsjax/core/config.py.

Field for field the same names and defaults as the JAX package, so a
configuration moves between the two packages unchanged. Defaults are
graphdeco-compatible:
  - low-pass: cov2d diagonal += 0.3
  - cull: z < 0.2
  - footprint radius: ceil(3·sqrt(λ_max))
  - alpha: min(0.99, opacity·exp(power)); skip below 1/255
  - termination: stop before a splat would push transmittance below 1e-4

Knobs that size TPU-only machinery are accepted and have no effect here:
  stream_band_cap, stream_block_tiles, stream_dma_chunk, stream_unroll,
  stream_oh_cache — VMEM band scratch, DMA chunking, grid-step grouping
      and one-hot caching of the TPU stream kernels; the CUDA blend reads
      its attributes straight from device memory, so there is no band
      scratch and `n_band_overflow` always reads 0;
  stream_exact_table — the port's blend always reads exact f32
      attributes (the TPU needed a bf16 split table for its MXU gather);
  pair_repack, repack_w, repack_q, repack_cap, repack_rows — the TPU's
      2-D row-sort replacement for a slow global sort; the port sorts
      pairs with one stable sort, so `n_repack_overflow` always reads 0.
The tile-sharded fields (band_*_slack, shard_*_cap) wait for the
multi-device port.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    tile_size: int = 16
    # each (home row of a) splat emits up to tile_span² pairs; the stream
    # backend requires 3
    tile_span: int = 3
    # per-tile list capacity of the padded-list (xla) backend
    tile_list_cap: int = 1024
    # total-pair budget; None = no cap. Overflow is counted in aux
    pair_cap: int | None = None
    chunk: int = 128  # pairs per compositing step
    near_cull: float = 0.2
    lowpass: float = 0.3
    alpha_clamp: float = 0.99
    alpha_min: float = 1.0 / 255.0
    transmittance_eps: float = 1e-4
    radius_sigma: float = 3.0
    background: tuple = (0.0, 0.0, 0.0)
    # stream | pallas (the flat slot-stream kernels E, F) | auto (= stream);
    # oracle, xla: not yet
    backend: str = "auto"
    # False: exact footprints — fat splats split into per-3×3-tile-block
    # home rows (render/homesort.py); True: legacy span-budget clamp
    footprint_clamp: bool = False
    # exact-mode budgets (render/homesort.resolve_fat_caps); overflow is
    # counted in aux n_fat_overflow, never silent. fat_max_blocks must
    # stay < 1024, as in the reference
    fat_max_blocks: int = 1023
    fat_cap: int | None = None
    fat_live_cap: int | None = None
    # --- TPU-only knobs: accepted, no effect (see module docstring) ---
    stream_band_cap: int = 53248
    stream_block_tiles: int = 6
    stream_dma_chunk: int = 2048
    stream_exact_table: bool = False
    pair_repack: bool = True
    repack_w: int = 32768
    repack_q: int | None = None
    repack_cap: int | None = None
    repack_rows: int | None = None
    # --- tile-sharded path (not ported yet) ---
    band_prefilter_slack: float = 2.5
    band_slice_slack: float = 2.0
    shard_prefilter_cap: int | None = None
    shard_slice_cap: int | None = None
    stream_unroll: int = 4
    stream_oh_cache: bool = False

    def tiles_x(self, width: int) -> int:
        return -(-width // self.tile_size)

    def tiles_y(self, height: int) -> int:
        return -(-height // self.tile_size)
