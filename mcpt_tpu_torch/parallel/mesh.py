"""Device lists for rendering and inverse rendering (counterpart of
`mcpt_tpu/parallel/mesh.py`).

JAX lays lanes over a 1-D `Mesh` and replicates the scene pack; here a
"mesh" is a list of torch devices (one may be listed several times, which
runs every share on one device), the pack is copied once to each distinct
device, and lane batches split along axis 0 into equal contiguous blocks,
one per entry, as `PartitionSpec(LANE_AXIS)` splits them. The gradient
all-reduce of the train step (`diff.py`) averages over the entries, and
over processes where `torch.distributed` is initialised
(`parallel/distributed.py`).
"""

import torch

from mcpt_tpu_torch.intersect import wavefront_pack


def make_mesh(n_devices=None) -> list:
    """The first `n_devices` CUDA devices (default: all of them); raises
    when the host has fewer."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = have if n_devices is None else int(n_devices)
    if n < 1 or n > have:
        raise RuntimeError(f"make_mesh: asked for {n_devices} CUDA devices, the host has {have}")
    return [torch.device(f"cuda:{k}") for k in range(n)]


def replicate_pack(pack, devices, method: str = "auto") -> dict:
    """{device: (the compiled `pack` moved there for the wavefront, the
    intersector method it resolves to there)}, one entry per distinct
    device of `devices` (`intersect.wavefront_pack`)."""
    out = {}
    for dev in map(torch.device, devices):
        if dev not in out:
            out[dev] = wavefront_pack(pack, dev, method)
    return out


def shard_lanes(devices, lanes):
    """`lanes` split along axis 0 into len(devices) equal contiguous blocks,
    block k moved to devices[k]; axis 0 must divide."""
    n = len(devices)
    if lanes.shape[0] % n:
        raise ValueError(f"shard_lanes: {lanes.shape[0]} lanes over {n} devices")
    return [blk.to(dev) for blk, dev in zip(torch.chunk(lanes, n), devices)]
