"""Fragment parallelism over a mesh of devices.

JAX counterpart: ``quemb_tpu/parallel/mesh.py``.  Fragments are
independent work items, so the fragment axis of a batched bucket is split
over a 1-D mesh (axis "frag") and the same batched pipeline runs on each
piece.  Where the JAX module runs one SPMD program over its mesh, this
one stays one process: each shard's piece runs on its own thread, under
its device, and the per-fragment results come back to where they are
used.  There is no collective: the only traffic between devices is the
copy of a shard's operands to it and the gather of its results.  The
batched fragment SCF and the CCSD loop read a convergence flag back to
the host once per iteration, so the threads are what let the shards'
devices work at the same time.

A mesh may name a device more than once, and may name the CPU: two
shards on one card, or a card and the CPU, run the same code as two
cards, which is how a one-card machine checks that no operation mixes
tensors of two shards.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import torch

from quemb_tpu_torch.utils.profiling import attached, current


@dataclass(frozen=True)
class Mesh:
    """A 1-D device mesh: ``devices`` in shard order."""

    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...] = ("frag",)

    @property
    def size(self) -> int:
        return len(self.devices)


_MESH: Mesh | None = None


def set_mesh(mesh: Mesh | None) -> None:
    """Install a global fragment mesh (None disables sharding)."""
    global _MESH
    _MESH = mesh


def get_mesh() -> Mesh | None:
    return _MESH


def _indexed(device: torch.device) -> torch.device:
    """``device`` with its index: a bare ``cuda`` is the current card."""
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"make_fragment_mesh: {device} is named but no CUDA device"
                " is available"
            )
        if device.index is None:
            return torch.device("cuda", torch.cuda.current_device())
    return device


def make_fragment_mesh(devices=None) -> Mesh:
    """1-D mesh with axis name 'frag' over every visible card, or over the
    given devices (which may repeat and may include ``cpu``).  Without a
    card and without devices it raises: the CPU is used only when named."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_fragment_mesh(): no CUDA device is available; pass"
                " devices=[...] (for example ['cpu', 'cpu']) to shard over"
                " named devices"
            )
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = tuple(_indexed(torch.device(d)) for d in devices)
    if not devices:
        raise ValueError("make_fragment_mesh: no devices")
    return Mesh(devices)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def shard_ranges(n: int, mesh: Mesh | None = None):
    """[(range, device)]: contiguous pieces of a batch of ``n``, one per
    shard that gets any (``torch.tensor_split``'s division: the first
    ``n % size`` shards hold one more).  Without a mesh: one piece, device
    None (the batch stays where it is)."""
    mesh = mesh or _MESH
    if mesh is None:
        return [(range(n), None)]
    q, r = divmod(n, mesh.size)
    out, start = [], 0
    for k, device in enumerate(mesh.devices):
        stop = start + q + (k < r)
        if stop > start:
            out.append((range(start, stop), device))
        start = stop
    return out


def shard_batch(arr, mesh: Mesh | None = None):
    """Split a [nf, ...] batch along its leading axis over 'frag'.

    Returns (pieces, nf): the pieces in shard order, each on its shard's
    device, and the true count.  The JAX function pads the batch (with
    copies of the last element) to a multiple of the mesh size, so that
    every device compiles one shape; eager torch compiles nothing per
    shape, so the pieces here are split as ``torch.tensor_split`` splits
    them and a shard with no element gets no piece.  Without a mesh the
    one piece is the batch, where it lies.
    """
    arr = torch.as_tensor(arr)
    nf = arr.shape[0]
    return [arr[r.start:r.stop] if d is None else arr[r.start:r.stop].to(d)
            for r, d in shard_ranges(nf, mesh)], nf


def run_on_shards(fn, chunks, devices):
    """``fn(chunk, device)`` for each chunk on its device, on one thread
    per chunk (inline for a single chunk), a card's under
    ``torch.cuda.device``; returns the results in shard order.  A shard's
    exception propagates (the other shards finish first).  The tracer's
    spans and counts of a shard go under the caller's open span."""
    def call(chunk, device):
        if device is not None and device.type == "cuda":
            with torch.cuda.device(device):
                return fn(chunk, device)
        return fn(chunk, device)

    if len(chunks) == 1:
        return [call(chunks[0], devices[0])]
    parent = current()

    def shard(chunk, device):
        with attached(parent):
            return call(chunk, device)

    with ThreadPoolExecutor(max_workers=len(chunks)) as pool:
        futures = [pool.submit(shard, c, d) for c, d in zip(chunks, devices)]
        return [f.result() for f in futures]


def map_batches(fn, *batches):
    """``fn(*pieces)`` over the shards of ``batches`` (batched tensors of
    one leading size, split by :func:`shard_batch` over the active mesh);
    the output tuples' tensors are concatenated along the batch axis in
    shard order on the first batch's device."""
    batches = [torch.as_tensor(b) for b in batches]
    out_device = batches[0].device
    pieces = list(zip(*(shard_batch(b)[0] for b in batches)))
    outs = run_on_shards(lambda p, _: fn(*p), pieces,
                         [p[0].device for p in pieces])
    return tuple(torch.cat([x.to(out_device) for x in xs])
                 for xs in zip(*outs))
