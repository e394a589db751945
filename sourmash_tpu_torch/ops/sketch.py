"""Batched k-mer sketching on the device: raw bytes -> window hashes.

Counterpart of `sourmash_tpu/ops/sketch.py:seq_chunks_to_hashes` with the
same chunking, batching, survivor caps and reroutes, so the two return the
same hashes in the same order with the same multiplicity:

- the input is uppercased on the host and cut into chunks of `chunk`
  windows that overlap by k-1 bytes, zero-padded to one row shape;
- at scaled >= 512 (`_slot_path_ok`) a batch of rows goes through K1
  (`cuda_sketch.survivor_slots`) and the torch epilogue
  `_compact_slots_device`, with one readback per batch;
- rows where a segment overflowed its slots, and every row otherwise (num
  sketches, scaled < 512), go through K2 (`cuda_sketch.window_hashes`),
  the threshold and `_compact_keep`; a row whose survivors exceed `cap` is
  redone alone at full capacity.

Multi-record buffers come pre-joined with k-1 'N' bytes (see
`sequence_io.iter_record_batches`): windows that cross a record boundary
hold an invalid byte and are dropped, which gives per-record semantics.

`aa_chunks_to_hashes` is the amino-acid counterpart
(`sourmash_tpu/ops/sketch.py:aa_chunks_to_hashes`): the same chunks and
batches through K3 (`cuda_sketch.aa_window_hashes`), returning every window
hash in order; thresholding is the caller's.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cuda_sketch, u64
from . import resolve_device
from .encodings import UPPER

SMALL_INPUT = 1 << 16  # below this many bytes the numpy twin hashes on the host
MAX_BATCH = 32


def _slot_path_ok(max_hash) -> bool:
    """The in-kernel segment compaction path applies when survivors are
    sparse: expected density 128/scaled per segment must leave headroom
    under 8 slots (scaled >= 512 => lambda <= 0.25, P[Poisson > 8] ~ 3e-10
    per segment)."""
    return int(max_hash) <= (1 << 64) // 512


def _pick_slots(max_hash) -> int:
    """Slots per 128-window segment: 4 at scaled >= 768 (a segment then
    overflows 4 slots with P ~ 9e-7, and its row is redone on the dense
    path), 8 below that, down to the scaled=512 gate."""
    return 4 if int(max_hash) <= (1 << 64) // 768 else 8


def _compact_keep(keep: torch.Tensor, values: torch.Tensor, cap: int):
    """Per row, the values where `keep` is set, in order, in the first
    n_valid of `cap` slots padded with 2^64-1 (-1 as int64); and n_valid
    per row.

    keep [B, m] bool, values [B, m] int64 -> ([B, cap] int64, [B] int64).
    Like the JAX epilogue, a row with n_valid > cap keeps its first cap
    survivors and reports the true n_valid, so the caller can redo it."""
    pos = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    n_valid = pos[:, -1] + 1
    dest = torch.where(keep & (pos < cap), pos, cap)
    out = torch.full((keep.shape[0], cap + 1), -1, dtype=torch.int64, device=keep.device)
    out.scatter_(1, dest, values)
    return out[:, :cap], n_valid


def _compact_slots_device(sh, sl, cnt, cap: int):
    """Device epilogue of K1: slot planes [B, R, slots] -> dense [B, cap]
    survivors in window order, per-row survivor counts and per-row
    slot-overflow flags. Compacting on the device keeps the readback at
    [B, cap] instead of the slot planes."""
    B, R, slots = sh.shape
    mask = torch.arange(slots, device=sh.device) < cnt[:, :, None]
    bad = (cnt > slots).any(dim=1)
    vals = u64.join32(sh, sl).view(B, R * slots)
    dense, n_row = _compact_keep(mask.view(B, R * slots), vals, cap)
    return dense, n_row, bad


def _dense_compact(rows: torch.Tensor, max_hash: int, ksize: int, seed: int, cap: int):
    """K2 path for a batch of rows: hashes of the valid windows with
    hash <= max_hash, compacted per row -> ([B, cap] int64, [B] int64)."""
    n = rows.shape[1] - ksize + 1
    hashes, valid = cuda_sketch.window_hashes(rows, ksize=ksize, seed=seed)
    hashes = hashes[:, :n]
    keep = (valid[:, :n] != 0) & u64.le(hashes, max_hash)
    return _compact_keep(keep, hashes, cap)


def _readback(*tensors):
    """Bring int64-convertible device tensors to the host as numpy arrays in
    ONE transfer (one synchronisation instead of one per tensor)."""
    flat = torch.cat([t.reshape(-1).to(torch.int64) for t in tensors]).cpu().numpy()
    out, at = [], 0
    for t in tensors:
        out.append(flat[at : at + t.numel()].reshape(tuple(t.shape)))
        at += t.numel()
    return out


def seq_chunks_to_hashes(
    seq_bytes: bytes,
    ksize: int,
    max_hash: int,
    seed: int = 42,
    chunk: int = 1 << 21,
    cap: int | None = None,
    *,
    device=None,
):
    """Raw sequence bytes -> np.uint64 array of the surviving window hashes
    (valid, hash <= max_hash), with multiplicity, in window order per chunk.

    `seq_bytes` may be a multi-record buffer pre-joined with (k-1) b'N'
    separators; uppercasing is applied here. Inputs of at least SMALL_INPUT
    bytes run on `device` (see `ops.resolve_device`)."""
    arr = UPPER[np.frombuffer(seq_bytes, dtype=np.uint8)]
    S = arr.shape[0]
    if S < ksize:
        return np.zeros(0, dtype=np.uint64)

    if S < SMALL_INPUT:
        # small input: the host numpy twin beats the device round trip
        from .encodings import dna_hashes

        h, valid = dna_hashes(arr, ksize, seed)
        return h[valid & (h <= np.uint64(max_hash))]

    dev = resolve_device(device)
    max_hash = int(max_hash)
    # survivor cap per chunk: ~4x expected for the scaled path; the whole
    # chunk for num sketches (max_hash == 2^64-1)
    if cap is None:
        if max_hash >= (1 << 63):
            cap = chunk
        else:
            expected = int(chunk * (float(max_hash) / 2**64)) + 1
            cap = max(4096, 1 << int(np.ceil(np.log2(4 * expected + 1024))))
            cap = min(cap, chunk)

    pieces = []
    for s in range(0, max(S - ksize + 1, 1), chunk):
        piece = arr[s : min(s + chunk + ksize - 1, S)]
        if piece.shape[0] < ksize:
            continue
        pad = (chunk + ksize - 1) - piece.shape[0]
        if pad > 0:
            piece = np.concatenate([piece, np.zeros(pad, dtype=np.uint8)])
        pieces.append(piece)
    if not pieces:
        return np.zeros(0, dtype=np.uint64)

    slot_path = _slot_path_ok(max_hash)
    out = []
    for b0 in range(0, len(pieces), MAX_BATCH):
        batch = np.stack(pieces[b0 : b0 + MAX_BATCH])
        if slot_path:
            rows = torch.from_numpy(batch).to(dev)
            sh, sl, cnt = cuda_sketch.survivor_slots(
                rows, max_hash, ksize=ksize, seed=seed, slots=_pick_slots(max_hash)
            )
            vals, n_row, bad = _readback(*_compact_slots_device(sh, sl, cnt, cap))
            bad_rows = []
            for i in range(len(n_row)):
                # slot overflow or survivor-cap overflow: dense-path retry
                if bad[i] or int(n_row[i]) > cap:
                    bad_rows.append(i)
                elif n_row[i]:
                    out.append(vals[i, : int(n_row[i])].view(np.uint64))
            if not bad_rows:
                continue
            batch = batch[np.asarray(bad_rows)]
        rows = torch.from_numpy(batch).to(dev)
        vals, n_valid = _readback(*_dense_compact(rows, max_hash, ksize, seed, cap))
        for i, nv in enumerate(n_valid):
            nv = int(nv)
            if nv == 0:
                continue
            if nv > cap:
                # rare overflow: redo this chunk at full capacity
                v2, n2 = _readback(
                    *_dense_compact(rows[i : i + 1], max_hash, ksize, seed, chunk)
                )
                out.append(v2[0, : int(n2[0])].view(np.uint64))
            else:
                out.append(vals[i, :nv].view(np.uint64))
    if not out:
        return np.zeros(0, dtype=np.uint64)
    return np.concatenate(out)


def aa_chunks_to_hashes(
    aa_arr: np.ndarray,
    ksize: int,
    seed: int = 42,
    chunk: int = 1 << 21,
    mask_invalid: bool = False,
    *,
    device=None,
):
    """Uppercased (and, for dayhoff/hp, remapped) amino-acid bytes ->
    np.uint64 hashes of ALL windows in window order: protein hashing
    applies no residue validity (reference `signature.rs:362-393`). With
    mask_invalid, windows holding a zero byte are dropped: the record
    separator of the batched CLI path (amino-acid bytes are never 0).

    Chunks of `chunk` windows overlap by k-1 bytes and are zero-padded to
    one row shape; up to MAX_BATCH rows go through K3 on `device` (see
    `ops.resolve_device`) and come back in one readback per batch, trimmed
    to each row's real windows on the device."""
    S = aa_arr.shape[0]
    n_total = S - ksize + 1
    if n_total <= 0:
        return np.zeros(0, dtype=np.uint64)
    dev = resolve_device(device)

    pieces, counts = [], []
    for s in range(0, n_total, chunk):
        piece = aa_arr[s : min(s + chunk + ksize - 1, S)]
        counts.append(piece.shape[0] - ksize + 1)
        pad = (chunk + ksize - 1) - piece.shape[0]
        if pad > 0:
            piece = np.concatenate([piece, np.zeros(pad, dtype=np.uint8)])
        pieces.append(piece)

    out = []
    for b0 in range(0, len(pieces), MAX_BATCH):
        rows = torch.from_numpy(np.stack(pieces[b0 : b0 + MAX_BATCH])).to(dev)
        hashes, valid = cuda_sketch.aa_window_hashes(rows, ksize=ksize, seed=seed)
        cnt = torch.tensor(counts[b0 : b0 + MAX_BATCH], device=dev)
        keep = torch.arange(hashes.shape[1], device=dev) < cnt[:, None]
        if mask_invalid:
            keep &= valid != 0
        (h,) = _readback(hashes[keep])
        out.append(h.view(np.uint64))
    return np.concatenate(out)


def hashes_to_mins(hashes: np.ndarray, track_abundance: bool):
    "Survivor hash multiset -> (sorted unique mins, abundances|None)."
    if hashes.size == 0:
        empty = np.zeros(0, dtype=np.uint64)
        return empty, (np.zeros(0, dtype=np.uint64) if track_abundance else None)
    if track_abundance:
        mins, counts = np.unique(hashes, return_counts=True)
        return mins.astype(np.uint64), counts.astype(np.uint64)
    return np.unique(hashes).astype(np.uint64), None
