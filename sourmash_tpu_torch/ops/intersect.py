"""Batched set-intersection counts with engine dispatch: the port of
`sourmash_tpu/ops/intersect.py`. `query_vs_many_cutoff_counts` serves
`Index._find_batched`; `pairwise_intersection_counts` (the all-pairs
matrix of `compare`) and `query_intersection_counts` the counts without
cutoffs.

Two engines sit behind each, chosen by the device alone, as the JAX
package chooses per backend:

- **bucketed** (`ops/bucketed.py`): dense equality compares over
  low-bit-bucketed u32 planes, the hand-written `counts_rows` kernel (with
  per-row cutoffs) and, for the all-pairs matrix, the `pairwise_counts`
  hash join of the bank's valid slots (`ops/cuda_pairwise.py`). The CUDA
  path.
- **sorted** (this module, X7): padded sorted `[n, L]` rows and a
  vectorised `torch.searchsorted` on sign-flipped int64 (unsigned order):
  O(L log L) work that suits the CPU.

Below `_HOST_WORK_CUTOFF` of merge work both wrappers join on the host
with `np.intersect1d`, whatever the device.
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


_ROW_BLOCK = 8  # query rows per step of the all-pairs matrix


def _hits(fH, lens, fq):
    """[n, m] bool: is each flipped query value fq [n, m] (row i searched
    in row i of fH) stored in that row of the flipped padded rows fH [n, L]
    of lengths lens [n]?"""
    idx = torch.searchsorted(fH, fq)
    idxc = idx.clamp(0, fH.shape[1] - 1)
    return (idx < lens[:, None]) & (fH.gather(1, idxc) == fq)


def _query_block_vs_many_counts(qs, q_lens, H, lens):
    """[b, Lq] query rows (lengths q_lens [b]) vs [n, L] rows -> [b, n]
    int32 intersection counts, hashes as int64 bit patterns. The
    all-pairs matrix streams blocks of query rows through this, so the
    hit mask stays [n, b * Lq] instead of [n, n * L]."""
    b, Lq = qs.shape
    n = H.shape[0]
    fq = u64.flip(qs).reshape(1, b * Lq).expand(n, -1).contiguous()
    hit = _hits(u64.flip(H), lens, fq).view(n, b, Lq)
    valid_q = torch.arange(Lq, device=qs.device)[None, :] < q_lens[:, None]  # [b, Lq]
    return (hit & valid_q[None]).sum(dim=2, dtype=torch.int32).T


def _pairwise_counts(H, lens):
    """[n, L] sorted padded rows (int64 bit patterns, n a multiple of
    _ROW_BLOCK) -> [n, n] int32 numpy intersection-count matrix, computed
    in _ROW_BLOCK-row slabs."""
    n = H.shape[0]
    out = np.empty((n, n), dtype=np.int32)
    for i in range(0, n, _ROW_BLOCK):
        out[i : i + _ROW_BLOCK] = _query_block_vs_many_counts(
            H[i : i + _ROW_BLOCK], lens[i : i + _ROW_BLOCK], H, lens
        ).cpu().numpy()
    return out


def _query_vs_many_counts(q, q_len, H, lens):
    """[Lq] query row vs [n, L] rows -> [n] int32 intersection counts. Lq
    is independent of L: the query is binary-searched into each row."""
    fq = u64.flip(q)[None, :].expand(H.shape[0], -1).contiguous()
    valid_q = torch.arange(q.shape[0], device=q.device)[None, :] < q_len
    return (_hits(u64.flip(H), lens, fq) & valid_q).sum(dim=1, dtype=torch.int32)


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
    hit = _hits(fH, lens, fq[None, :].expand(H.shape[0], -1).contiguous()) & valid_q
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


# Below this much total merge work, host np.intersect1d beats any device
# dispatch (the JAX package's cutoff, kept so that both packages give the
# same matrices on the same inputs by the same engines).
_HOST_WORK_CUTOFF = 2_000_000


def _host_pairwise_counts(mins_list, n):
    counts = np.zeros((n, n), dtype=np.int64)
    for i in range(n):
        counts[i, i] = len(mins_list[i])
        for j in range(i + 1, n):
            c = len(np.intersect1d(mins_list[i], mins_list[j], assume_unique=True))
            counts[i, j] = counts[j, i] = c
    return counts


def pairwise_intersection_counts(mins_list, device=None) -> np.ndarray:
    """Host wrapper: list of sorted uint64 arrays -> [n, n] int64 count
    matrix. Host joins below the cutoff; above it the `pairwise_counts`
    join on CUDA, the sorted engine on the CPU."""
    from . import resolve_device

    n = len(mins_list)
    if not n:
        return np.zeros((0, 0), dtype=np.int64)
    if n * sum(len(m) for m in mins_list) < _HOST_WORK_CUTOFF:
        return _host_pairwise_counts(mins_list, n)
    device = resolve_device(device)
    if device.type == "cuda":
        from . import bucketed

        return bucketed.pairwise_counts_bucketed(mins_list, device=device)
    H, lens = pack_sketches(mins_list, pad_rows=True)
    out = _pairwise_counts(u64.from_numpy(H).to(device), torch.from_numpy(lens).to(device))
    return out[:n, :n].astype(np.int64)


def query_intersection_counts(query_mins, mins_list, device=None) -> np.ndarray:
    """Host wrapper: one sorted uint64 query vs many sketches -> [n] int64
    counts, with the engines of `pairwise_intersection_counts`."""
    from . import resolve_device

    n = len(mins_list)
    if not n:
        return np.zeros(0, dtype=np.int64)
    q = np.asarray(query_mins, dtype=np.uint64)
    total = len(q) * n + sum(len(m) for m in mins_list)
    if total < _HOST_WORK_CUTOFF:
        return np.array(
            [len(np.intersect1d(q, m, assume_unique=True)) for m in mins_list],
            dtype=np.int64,
        )
    device = resolve_device(device)
    if device.type == "cuda":
        from . import bucketed

        B = bucketed.choose_buckets(max((len(m) for m in mins_list), default=0))
        bank = bucketed.pack_rows_bucketed(list(mins_list), B, device=device)
        return bucketed.query_counts_bucketed(q, bank)
    H, lens = pack_sketches(mins_list, pad_rows=True)
    qp, q_len = pack_query(q)
    out = _query_vs_many_counts(
        u64.from_numpy(qp).to(device), q_len, u64.from_numpy(H).to(device),
        torch.from_numpy(lens).to(device),
    )
    return out.cpu().numpy()[:n].astype(np.int64)
