"""Batched query-vs-many intersection counts with per-pair cutoffs, with
engine dispatch: the port of `sourmash_tpu/ops/intersect.py` as far as
`Index._find_batched` needs it.

Two engines sit behind `query_vs_many_cutoff_counts`, chosen by the
device alone, as the JAX package chooses per backend:

- **bucketed** (`ops/bucketed.py`): dense equality compares over
  low-bit-bucketed u32 planes, the hand-written `counts_rows` kernel with
  per-row cutoffs. The CUDA path.
- **sorted** (this module): padded sorted `[n, L]` rows and a vectorised
  `torch.searchsorted` on sign-flipped int64 (unsigned order): O(L log L)
  work that suits the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from . import u64

MAX_U64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def _next_pow2(x: int) -> int:
    return 1 << max(0, int(x - 1).bit_length())


def pack_sketches(mins_list, pad_rows=False) -> tuple[np.ndarray, np.ndarray]:
    """Pack a list of sorted uint64 arrays into ([n, L] padded array, [n]
    lengths). L is the next power of two (>= 128); with pad_rows, n is
    rounded the same way (>= 8), and padding rows have length 0."""
    n = len(mins_list)
    L = _next_pow2(max(128, max((len(m) for m in mins_list), default=0)))
    rows = _next_pow2(max(8, n)) if pad_rows else n
    H = np.full((rows, L), MAX_U64, dtype=np.uint64)
    lens = np.zeros(rows, dtype=np.int32)
    for i, m in enumerate(mins_list):
        H[i, : len(m)] = m
        lens[i] = len(m)
    return H, lens


def pack_query(q_mins: np.ndarray) -> tuple[np.ndarray, int]:
    "Pad one sorted query row to a power-of-two length (>= 128)."
    n = len(q_mins)
    q = np.full(_next_pow2(max(128, n)), MAX_U64, dtype=np.uint64)
    q[:n] = q_mins
    return q, n


def _query_vs_many_cutoffs(q, q_len, H, lens, cut_q, cut_s):
    """Query vs many with per-pair scaled cutoffs, on torch tensors (hashes
    as int64 bit patterns). cut_q[i]: cutoff applied to the query for pair
    i (2^64-1 = none); cut_s[i]: cutoff applied to subject i. Returns
    (shared, q_size, s_size) [n] int32, the reference's pairwise
    downsample semantics."""
    L = H.shape[1]
    fq = u64.flip(q)  # [Lq], unsigned order as signed order
    fH = u64.flip(H)  # [n, L]
    fcq = u64.flip(cut_q)[:, None]
    fcs = u64.flip(cut_s)[:, None]
    valid_q = (torch.arange(q.shape[0], device=q.device) < q_len)[None, :]
    both = torch.minimum(fcq, fcs)
    idx = torch.searchsorted(fH, fq[None, :].expand(H.shape[0], -1).contiguous())
    idxc = idx.clamp(0, L - 1)
    hit = (idx < lens[:, None]) & (fH.gather(1, idxc) == fq[None, :]) & valid_q
    hit &= fq[None, :] <= both
    shared = hit.sum(dim=1, dtype=torch.int32)
    q_size = (valid_q & (fq[None, :] <= fcq)).sum(dim=1, dtype=torch.int32)
    col = torch.arange(L, device=H.device)[None, :]
    s_size = ((col < lens[:, None]) & (fH <= fcs)).sum(dim=1, dtype=torch.int32)
    return shared, q_size, s_size


def _bucketed_cutoff_counts(query_mins, mins_list, cuts, device):
    "The bucketed engine: `counts_rows` with per-row cutoffs (the CUDA path)."
    from . import bucketed

    B = bucketed.choose_buckets(max((len(m) for m in mins_list), default=0))
    bank = bucketed.pack_rows_bucketed(list(mins_list), B, device=device)
    shared = bucketed.query_cutoff_counts_bucketed(query_mins, bank, cuts)
    # sizes under the cutoff: host binary search on the sorted mins
    q_sizes = np.searchsorted(query_mins, cuts, side="right").astype(np.int64)
    s_sizes = np.fromiter(
        (
            np.searchsorted(np.asarray(m, dtype=np.uint64), c, side="right")
            for m, c in zip(mins_list, cuts)
        ),
        dtype=np.int64,
        count=len(mins_list),
    )
    return shared, q_sizes, s_sizes


def _sorted_cutoff_counts(query_mins, mins_list, cuts, device):
    "The sorted engine: `_query_vs_many_cutoffs` on padded rows (the CPU path)."
    n = len(mins_list)
    H, lens = pack_sketches(list(mins_list), pad_rows=True)
    q, q_len = pack_query(query_mins)
    cut = np.full(len(lens), MAX_U64, dtype=np.uint64)
    cut[:n] = cuts
    cut_t = u64.from_numpy(cut).to(device)
    shared, qs, ss = _query_vs_many_cutoffs(
        u64.from_numpy(q).to(device),
        q_len,
        u64.from_numpy(H).to(device),
        torch.from_numpy(lens).to(device),
        cut_t,
        cut_t,
    )
    return (
        shared.cpu().numpy()[:n].astype(np.int64),
        qs.cpu().numpy()[:n].astype(np.int64),
        ss.cpu().numpy()[:n].astype(np.int64),
    )


def query_vs_many_cutoff_counts(query_mins, mins_list, pair_cutoffs, device=None):
    """Host wrapper for per-pair-downsampled query-vs-many scoring.

    pair_cutoffs[i] is the max_hash of the pair's common scaled (see
    `Index._find_batched`). Cutoffs apply to whichever side has hashes
    above them, reproducing flatten_and_downsample_scaled exactly.
    Returns (shared [n], query_sizes [n], subject_sizes [n]) int64."""
    from . import resolve_device

    if len(mins_list) == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z, z
    device = resolve_device(device)
    engine = _bucketed_cutoff_counts if device.type == "cuda" else _sorted_cutoff_counts
    return engine(
        np.asarray(query_mins, dtype=np.uint64),
        mins_list,
        np.asarray(pair_cutoffs, dtype=np.uint64),
        device,
    )
