"""The band mesh of the tile-sharded path — the PyTorch counterpart of
gsjax/parallel/mesh.py.

gsjax runs one SPMD program over a 1-D `tiles` device mesh: the image's
tile rows sharded over the devices, the splat parameters replicated, the
gradients summed by `psum`. Here a Mesh is `n_bands` tile-row bands over
the ranks of a torch.distributed process group: with world size w
(n_bands % w == 0) rank r owns bands [r·n/w, (r+1)·n/w); with group=None
the one process owns them all (the counterpart of JAX's virtual devices:
the CPU tests and one-card runs use it). A rank renders its bands one
after another; `all_reduce_` sums one flat buffer over the group.

No code picks a backend or a device for the caller: `init_multihost`
takes the collective backend (NCCL across the cards of a host; gloo on
the CPU, and for two processes on one card, which NCCL refuses), and
nothing falls back from one to the other.
"""

from __future__ import annotations

import dataclasses

import torch

TILES_AXIS = "tiles"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """n_bands tile-row bands on `device`, owned by the ranks of `group`
    (a torch.distributed process group; None: this process owns all).
    The sharded render and steps check that the scene is on `device`."""

    n_bands: int
    device: torch.device
    group: object = None

    def __post_init__(self):
        if self.n_bands < 1 or self.n_bands % self.world:
            raise ValueError(f"{self.n_bands} bands do not split over {self.world} ranks")

    @property
    def shape(self) -> dict:
        """{TILES_AXIS: n_bands}, as a JAX mesh's shape reads."""
        return {TILES_AXIS: self.n_bands}

    @property
    def world(self) -> int:
        if self.group is None:
            return 1
        import torch.distributed as dist

        return dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        if self.group is None:
            return 0
        import torch.distributed as dist

        return dist.get_rank(self.group)

    def owned_bands(self) -> range:
        """The bands this rank renders, in order."""
        per = self.n_bands // self.world
        return range(self.rank * per, (self.rank + 1) * per)

    def check(self, g) -> None:
        """Raise unless g (a Gaussians or a tensor) lies on the mesh's
        device: a band mesh moves nothing between devices."""
        dev = torch.device(g.device)
        if dev.type != self.device.type or self.device.index not in (None, dev.index):
            raise ValueError(f"the scene is on {dev}, the mesh on {self.device}")

    def all_reduce_(self, flat: torch.Tensor) -> torch.Tensor:
        """Sum `flat` over the group in place (nothing without a group)."""
        if self.group is not None:
            import torch.distributed as dist

            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
        return flat


def make_mesh(n_devices: int, device="cuda", group=None) -> Mesh:
    """A band mesh of n_devices bands on `device` (every rank passes its
    own), over `group` (None: one process renders every band)."""
    return Mesh(int(n_devices), torch.device(device), group)


def init_multihost(backend: str, init_method: str, world_size: int, rank: int):
    """torch.distributed.init_process_group with everything given (the
    machine tells a program nothing of a cluster): `backend` "nccl" or
    "gloo", `init_method` a "tcp://host:port" or "file://path" store.
    Returns the default group, which make_mesh takes."""
    import torch.distributed as dist

    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return dist.group.WORLD


def band_rows_for(cfg, height: int, n_devices: int) -> int:
    """Tile rows per band; the image pads to n_devices · band_rows ·
    tile_size rows."""
    return -(-cfg.tiles_y(height) // n_devices)


def padded_height(cfg, height: int, n_devices: int) -> int:
    return band_rows_for(cfg, height, n_devices) * n_devices * cfg.tile_size


def band_rows_balanced(cfg, height: int, n_devices: int) -> int:
    """Tile rows per GROUP of the balanced split: the image splits into
    2·n_devices row groups and device d renders groups d and d + D, one
    from each half, so a center-heavy scene gives every device one dense
    and one sparse group."""
    return -(-cfg.tiles_y(height) // (2 * n_devices))


def balanced_group_order(n_devices: int) -> list:
    """The row groups in the balanced split's order: device d's share is
    groups d, d + n_devices."""
    order = []
    for d in range(n_devices):
        order += [d, d + n_devices]
    return order


def padded_height_balanced(cfg, height: int, n_devices: int) -> int:
    return band_rows_balanced(cfg, height, n_devices) * 2 * n_devices * cfg.tile_size
