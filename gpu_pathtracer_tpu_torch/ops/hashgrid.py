"""Spatial hash grid for photon-map radiance estimation (port of
`gpu_pathtracer_tpu.ops.hashgrid`).

World positions are quantized to integer cells of `cell_size` (the caller's
current max gather radius, so a radius-r query touches at most the 27 cells
around the query point); cell ids are hashed into 2**hash_bits buckets (x, y,
z prime XOR in wrapping int32 arithmetic, so buckets equal the reference's);
photons are sorted stably by bucket, and `bucket_start[h] .. bucket_start[h+1]`
is bucket h's slot range in `sorted_idx`.  Hash collisions only add far-away
candidates that the caller's distance test rejects.  A query gathers up to
`k_per_cell` photons from each of its 27 neighbour cells.
"""

from __future__ import annotations

import dataclasses

import torch

_P1 = 73856093
_P2 = 19349663
_P3 = 83492791


@dataclasses.dataclass
class HashGrid:
    sorted_idx: torch.Tensor  # (P,) int32 original photon rows, bucket order
    bucket_start: torch.Tensor  # (2**hash_bits + 2,) int32 exclusive prefix
    origin: torch.Tensor  # (3,) grid origin (min corner)
    cell_size: torch.Tensor  # () float32
    hash_bits: int = 20


def _cell_hash(ix, iy, iz, hash_bits: int):
    """int32 cell coordinates -> int32 bucket.  torch's int32 product wraps
    like the reference's; the mask keeps the low bits."""
    h = (ix * _P1) ^ (iy * _P2) ^ (iz * _P3)
    return torch.bitwise_and(h, (1 << hash_bits) - 1).to(torch.int32)


def _cells(pos, origin, cell):
    return torch.floor((pos - origin[None, :]) / cell).to(torch.int32)


def build_grid(pos, valid, cell_size, hash_bits: int = 20) -> HashGrid:
    """One stable sort builds the whole structure."""
    dev = pos.device
    origin = torch.amin(torch.where(valid[:, None], pos, float("inf")), dim=0)
    origin = torch.where(torch.isfinite(origin), origin, 0.0)
    cell = torch.clamp(torch.as_tensor(cell_size, dtype=torch.float32, device=dev), min=1e-12)
    q = _cells(pos, origin, cell)
    h = _cell_hash(q[:, 0], q[:, 1], q[:, 2], hash_bits)
    nb = 1 << hash_bits
    # invalid photons sort to the end into an out-of-range bucket
    h = torch.where(valid, h, nb)
    si = torch.sort(h, stable=True).indices.to(torch.int32)
    counts = torch.bincount(h.long(), minlength=nb + 1)
    bucket_start = torch.cat(
        [torch.zeros((1,), dtype=torch.int64, device=dev), torch.cumsum(counts, dim=0)]
    ).to(torch.int32)  # (nb + 2,); bucket b occupies [start[b], start[b+1])
    return HashGrid(sorted_idx=si, bucket_start=bucket_start, origin=origin, cell_size=cell,
                    hash_bits=hash_bits)


def _offsets(device):
    r = torch.arange(-1, 2, dtype=torch.int32, device=device)
    return torch.stack(torch.meshgrid(r, r, r, indexing="ij"), dim=-1).reshape(27, 3)


def _neighbour_buckets(grid: HashGrid, query_pos):
    """Per query the 27 neighbour cells' slot ranges and the cell-level
    dedup mask: two cells hashing to one bucket would return the same slots
    twice, so only each bucket's first cell counts.  (start, end, dup), each
    (R, 27)."""
    q = _cells(query_pos, grid.origin, grid.cell_size)
    cells = q[:, None, :] + _offsets(query_pos.device)[None, :, :]
    h = _cell_hash(cells[..., 0], cells[..., 1], cells[..., 2], grid.hash_bits).long()
    earlier = torch.tril(torch.ones((27, 27), dtype=torch.bool, device=h.device), diagonal=-1)
    dup = torch.any((h[..., None] == h[..., None, :]) & earlier[None], dim=-1)
    return grid.bucket_start[h], grid.bucket_start[h + 1], dup


def _dropped(start, end, dup, k: int):
    return torch.sum(torch.where(dup, 0, torch.clamp(end - start - k, min=0)),
                     dim=-1).to(torch.int32)


def query_candidates(grid: HashGrid, query_pos, k_per_cell: int = 16, with_stats: bool = False):
    """Candidate photon rows within the 27 cells around each query point:
    (idx, ok), (R, 27*K) int32 rows (clamped) and a bool mask; with
    `with_stats` also the (R,) int32 count of bucket entries dropped by the
    `k_per_cell` cap (an upper bound on in-radius photons lost).  Callers
    must still distance-test the candidates."""
    start, end, dup = _neighbour_buckets(grid, query_pos)
    k = k_per_cell
    p = grid.sorted_idx.shape[0]
    slots = start[..., None] + torch.arange(k, dtype=torch.int32, device=start.device)
    ok = (slots < end[..., None]) & ~dup[..., None]
    idx = grid.sorted_idx[torch.clamp(slots, 0, p - 1).long()]
    idx = idx.reshape(idx.shape[0], -1)
    ok = ok.reshape(ok.shape[0], -1)
    if with_stats:
        return idx, ok, _dropped(start, end, dup, k)
    return idx, ok


def query_cell_ranges(grid: HashGrid, query_pos, k_per_cell: int = 16, with_stats: bool = False):
    """Bucket-order variant of `query_candidates`: (starts, ok), the (R, 27)
    int32 slot starts into bucket-ordered photon arrays (`x[grid.sorted_idx]`)
    and the (R, 27, K) mask, identical to `query_candidates`'s.  Starts are
    not clipped: `gather_cell_slices` pads the payload by K rows."""
    start, end, dup = _neighbour_buckets(grid, query_pos)
    k = k_per_cell
    rel = torch.arange(k, dtype=torch.int32, device=start.device)
    ok = (start[..., None] + rel < end[..., None]) & ~dup[..., None]
    if with_stats:
        return start, ok, _dropped(start, end, dup, k)
    return start, ok


def cell_slots(starts, k_per_cell: int):
    """(R, 27*K) bucket-order slots of the K-wide slices at `starts`."""
    rel = torch.arange(k_per_cell, dtype=torch.int32, device=starts.device)
    return (starts[:, :, None] + rel[None, None, :]).reshape(starts.shape[0], -1)


def gather_cell_slices(payload_sorted, starts, k_per_cell: int):
    """(R, 27*K, D) candidate payloads from the bucket-ordered copy, padded by
    K rows so a tail bucket's slots stay in bounds without clamping (a clamp
    would shift rows off the caller's `ok` mask)."""
    pad = torch.zeros((k_per_cell,) + tuple(payload_sorted.shape[1:]),
                      dtype=payload_sorted.dtype, device=payload_sorted.device)
    return torch.cat([payload_sorted, pad])[cell_slots(starts, k_per_cell).long()]
