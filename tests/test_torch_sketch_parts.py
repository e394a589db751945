"""The sketch-kernel instruments (`ops/cuda_sketch_parts.py`, the tools in
`sourmash_tpu_torch/tools/`) against the JAX package's Pallas experiments,
on the CPU, where the port's wrappers run their plain PyTorch versions
(the CUDA kernels are held to these plain versions on the card by
`chip_smoke.py`). Every comparison is exact: the work is integer.

Route: the JAX tools hard-code `interpret=False` (T2, T3) or build their
own call (T4), so the tests load the modules from `tools/` with importlib
and run their kernel BODIES through their own `pl.pallas_call(...,
interpret=True)` with the tools' BlockSpecs, at rows = 8 (the least the
8 lookahead rows allow) and two blocks of 1,024 windows, on rows the tools'
own layout code builds.

- T2 pass A (`_assembly_kernel`): words and validity of every window,
  valid or not (garbage words of invalid windows bit-equal).
- T2 pass B (`_murmur_slots_kernel`) on pass A's outputs, and T3
  (`_slots_kernel_v2`): counts and every used slot equal. Where a segment
  has fewer survivors than slots, the JAX bodies' min-position loop selects
  every lane once none is left, so their unused slots hold the sum of the
  segment's 128 hash halves (mod 2^32), not K1's 0; that value is checked
  exactly too. The port gives K1's output, and the compositions are held
  to K1 (`sketch_survivor_slots_pallas(interpret=True)`) bit for bit, at
  max_hash 2^64/1000 and 2^64-1 with a tandem repeat that overflows slots.
- T4: murmur-only, assembly-only and the mul-chain (n = 0, 1, 2, 16; zeros
  for n >= 1, as in JAX) on the tool's random bytes 0..255.
- T5: the chained step's first call equals `survivor_slots_plain`.
- The CUDA designs of `split_words` and `assembly_only`, modelled in numpy
  tile by tile (K2's tile, or T4's staged from int32 quads; the eight-byte
  strand compare `strand8`; eight-byte words of the chosen run; T2's
  staging area), equal the JAX bodies and the plain versions on random
  bytes, ACGT with 2 % random bytes, N runs across the 128- and
  1,024-window boundaries, palindromes and zero tails (T4 also at rows = 9
  and 16 against the plain version).
- T3's design (`_v2_tiles`: K2's tile and plane strand, each thread's
  windows finished one at a time, only valid windows hashed, K1's segment
  order) equals `_slots_kernel_v2`, K1's plain version and the port's
  `survivor_slots_v2` at k = 21, 31, 33, 51 on such rows with an
  overflowing tandem repeat (at k = 7, 63, 129 against K1's plain
  version); the mul-chain's mapping (`_mulchain_groups`: four consecutive
  values a thread, the chains interleaved) equals `_mulchain_kernel` and
  the plain version at rows = 9 and 16 and 0, 1, 16 rounds.
- murmur_only's design (four values a thread, K1's k = 31 body folded,
  `_murmur31_fake`) and plain version equal `_murmur_only_kernel` at rows
  = 9 and 16; the integer-pipe probe's plain version equals its rounds in
  numpy uint64 arithmetic in every mode at 0, 1, 16 and 64 rounds; both
  wrappers refuse blocks off a 16-byte boundary, on the CPU too.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from sourmash_tpu.ops.encodings import dna_hashes
from sourmash_tpu.ops.pallas_sketch import sketch_survivor_slots_pallas
from sourmash_tpu_torch.ops import cuda_sketch as cs
from sourmash_tpu_torch.ops import cuda_sketch_parts as csp
from sourmash_tpu_torch.ops import u64
from sourmash_tpu_torch.ops.murmur import C1, C2
from test_torch_sketch_kernels import (
    _dna_tile, _funnel_murmur, _funnel_r, _plane_bits, _plane_strand)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS, EXTRA, LANES = 8, 8, 128
MH1000 = (2**64 - 1) // 1000
MAX_U64 = 2**64 - 1


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tools():
    return {n: _tool(n) for n in ("exp_split_kernel", "exp_v2_kernel", "profile_sketch_parts")}


def _rows(k, rng):
    """[2, S] rows over two 1,024-window blocks: ACGT with N, lowercase and
    bytes >= 128 (garbage windows), row 0 with a tandem repeat whose k-mer
    survives max_hash / 1000, row 1 ending in zero padding."""
    S = 1900 + k - 1
    alphabet = np.frombuffer(b"ACGTNa\xc7", dtype=np.uint8)
    rows = rng.choice(alphabet, size=(2, S), p=[0.235] * 4 + [0.02, 0.02, 0.02])
    rows[0, 300:700] = _tandem_repeat(k, rng)
    rows[1, S - 250 :] = 0
    return rows


def _tandem_repeat(k, rng):
    "400 bytes of a tandem repeat of an ACGT unit one of whose k-mers survives max_hash / 1000."
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    while True:
        unit = rng.choice(acgt, size=int(rng.integers(6, 15)))
        h, valid = dna_hashes(np.tile(unit, (k + 30) // len(unit) + 1), k, 42)
        if (valid & (h <= np.uint64(MH1000))).any():
            break
    return np.tile(unit, 400 // len(unit) + 1)[:400]


def _tool_blocks(rows, k):
    """The JAX tools' layout (`split_sketch`, `v2_sketch`): zero-padded rows
    cut into overlapping [ROWS + EXTRA, 128] int32 blocks."""
    B, S = rows.shape
    block = ROWS * LANES
    nblocks = -(-(S - k + 1) // block)
    padded = np.zeros((B, nblocks * block + EXTRA * LANES), dtype=np.int32)
    padded[:, :S] = rows
    idx = np.arange(nblocks)[:, None] * block + np.arange((ROWS + EXTRA) * LANES)[None, :]
    return padded[:, idx].reshape(-1, LANES), nblocks


def _mh_pair(mh):
    return jnp.asarray(np.array([[mh >> 32, mh & 0xFFFFFFFF]], dtype=np.uint32))


def _call(kernel, n_out, inputs, in_specs, n_blocks):
    blk = pl.BlockSpec((ROWS, LANES), lambda b: (b, np.int32(0)))
    out_shape = jax.ShapeDtypeStruct((n_blocks * ROWS, LANES), jnp.uint32)
    return pl.pallas_call(
        kernel, grid=(n_blocks,), in_specs=in_specs,
        out_specs=[blk] * n_out if n_out > 1 else blk,
        out_shape=[out_shape] * n_out if n_out > 1 else out_shape, interpret=True,
    )(*inputs)


def _smem_spec():
    return pl.BlockSpec((1, 2), lambda b: (np.int32(0), np.int32(0)), memory_space=pltpu.SMEM)


def _in_spec():
    return pl.BlockSpec((ROWS + EXTRA, LANES), lambda b: (b, np.int32(0)))


def _flat(a, B):
    "[B * nblocks * ROWS, 128] -> [B, windows] numpy."
    return np.asarray(a).reshape(B, -1)


def _check_packed(packed, port, hashes_u64, slots):
    """A JAX body's packed [B, R', 128] rows against the port's (hi, lo,
    counts): counts and used slots equal; unused slots hold the sum of the
    segment's hash halves."""
    hi, lo, cnt = (t.numpy() for t in port)
    B, R, _ = hi.shape
    packed = packed.reshape(B, -1, LANES)[:, :R]
    jcnt = packed[:, :, 2 * slots].astype(np.int32)
    assert np.array_equal(jcnt, cnt)
    h = hashes_u64.reshape(B, R, 128)
    sums = [((h >> np.uint64(s)) & np.uint64(0xFFFFFFFF)).sum(axis=-1, dtype=np.uint64)
            .astype(np.uint32) for s in (32, 0)]
    for j in range(slots):
        used = cnt > j
        for part, port_half, jsum in ((0, hi, sums[0]), (slots, lo, sums[1])):
            jv = packed[:, :, part + j]
            assert np.array_equal(jv[used], port_half[:, :, j].view(np.uint32)[used])
            assert np.array_equal(jv[~used], jsum[~used])
            assert not port_half[:, :, j][~used].any()
    assert (cnt > slots).any() and (cnt < slots).any()


K_CASES = [21, 31, 33]


@pytest.mark.parametrize("k", K_CASES)
def test_split_passes_match_pallas_bodies(k, tools):
    sp = tools["exp_split_kernel"]
    rng = np.random.default_rng(k)
    rows = _rows(k, rng)
    B = rows.shape[0]
    blocks, nblocks = _tool_blocks(rows, k)
    nw = csp.n_words(k)
    t = torch.from_numpy(rows)

    # pass A: canonical words and validity of every window
    outs = _call(functools.partial(sp._assembly_kernel, ksize=k, rows=ROWS, interpret=True),
                 2 * nw + 1, [jnp.asarray(blocks)], [_in_spec()], B * nblocks)
    words, valid = csp.split_words(t, ksize=k)
    n, R, n_pad = cs.geometry(rows.shape[1], k)
    assert words.shape == (B, n_pad, nw) and valid.shape == (B, n_pad)
    got = u64.to_numpy(words)
    for w in range(nw):
        lo_w = _flat(outs[2 * w], B)[:, :n_pad].astype(np.uint64)
        hi_w = _flat(outs[2 * w + 1], B)[:, :n_pad].astype(np.uint64)
        assert np.array_equal(got[:, :, w], (hi_w << np.uint64(32)) | lo_w), w
    assert np.array_equal(valid.numpy(), _flat(outs[-1], B)[:, :n_pad].astype(np.uint8))
    v = valid.numpy()[:, :n]
    assert v.any() and not v.all()

    # pass B on pass A's JAX outputs, and the composition against K1
    hashes = u64.to_numpy(cs.window_hashes(t, ksize=k)[0])
    for mh in (MH1000, MAX_U64):
        slots = 4 if mh == MH1000 else 8
        packed = _call(
            functools.partial(sp._murmur_slots_kernel, ksize=k, rows=ROWS, slots=slots), 1,
            [_mh_pair(mh), *outs], [_smem_spec()] + [pl.BlockSpec(
                (ROWS, LANES), lambda b: (b, np.int32(0)))] * (2 * nw + 1), B * nblocks)
        port = csp.split_slots(words, valid, mh, ksize=k, slots=slots)
        _check_packed(np.asarray(packed), port, hashes, slots)
        want = sketch_survivor_slots_pallas(jnp.asarray(rows), jnp.asarray(np.uint64(mh)),
                                            ksize=k, slots=slots, interpret=True)
        for g, w in zip(port, want):
            assert np.array_equal(g.numpy().view(np.asarray(w).dtype), np.asarray(w)[:, :R])


@pytest.mark.parametrize("k", K_CASES)
def test_v2_matches_pallas_body_and_k1(k, tools):
    v2 = tools["exp_v2_kernel"]
    rng = np.random.default_rng(100 + k)
    rows = _rows(k, rng)
    B = rows.shape[0]
    blocks, nblocks = _tool_blocks(rows, k)
    t = torch.from_numpy(rows)
    hashes = u64.to_numpy(cs.window_hashes(t, ksize=k)[0])
    R = cs.geometry(rows.shape[1], k)[1]
    for mh in (MH1000, MAX_U64):
        slots = 4 if mh == MH1000 else 8
        packed = _call(
            functools.partial(v2._slots_kernel_v2, ksize=k, rows=ROWS, slots=slots,
                              interpret=True), 1,
            [_mh_pair(mh), jnp.asarray(blocks)], [_smem_spec(), _in_spec()], B * nblocks)
        port = csp.survivor_slots_v2(t, mh, ksize=k, slots=slots)
        _check_packed(np.asarray(packed), port, hashes, slots)
        want = cs.survivor_slots_plain(t, mh, ksize=k, slots=slots)
        for g, w in zip(port, want):
            assert torch.equal(g, w)
        jk1 = sketch_survivor_slots_pallas(jnp.asarray(rows), jnp.asarray(np.uint64(mh)),
                                           ksize=k, slots=slots, interpret=True)
        for g, w in zip(port, jk1):
            assert np.array_equal(g.numpy().view(np.asarray(w).dtype), np.asarray(w)[:, :R])


@pytest.fixture(scope="module")
def t4(tools, request):
    "The T4 tool with its module rows cut to ROWS, and random byte blocks."
    pp = tools["profile_sketch_parts"]
    saved = pp.ROWS, pp.BROWS
    pp.ROWS, pp.BROWS = ROWS, ROWS + EXTRA
    request.addfinalizer(lambda: (setattr(pp, "ROWS", saved[0]), setattr(pp, "BROWS", saved[1])))
    blocks = np.random.default_rng(4).integers(0, 256, size=(3 * (ROWS + EXTRA), LANES))
    return pp, blocks.astype(np.int32)


def _t4_jax(kernel, blocks):
    return np.asarray(_call(kernel, 1, [jnp.asarray(blocks)], [_in_spec()],
                            blocks.shape[0] // (ROWS + EXTRA)))


def test_murmur_and_assembly_only_match_pallas_bodies(t4):
    pp, blocks = t4
    tb = torch.from_numpy(blocks)
    assert (csp.T4_KSIZE, csp.T4_SEED) == (pp.KSIZE, pp.SEED)
    got = csp.murmur_only(tb, rows=ROWS)
    assert got.shape == (3 * ROWS, LANES) and got.dtype == torch.int32
    assert np.array_equal(got.numpy().view(np.uint32), _t4_jax(pp._murmur_only_kernel, blocks))
    want = _t4_jax(functools.partial(pp._assembly_only_kernel, interpret=True), blocks)
    got = csp.assembly_only(tb, rows=ROWS)
    assert np.array_equal(got.numpy().view(np.uint32), want)
    assert len(np.unique(want)) > 1000  # garbage windows: the words count, not validity


@pytest.mark.parametrize("n", [0, 1, 2, 16])
def test_mulchain_matches_pallas_body(n, t4):
    pp, blocks = t4
    want = _t4_jax(functools.partial(pp._mulchain_kernel, n_rounds=n), blocks)
    got = csp.mulchain(torch.from_numpy(blocks), n, rows=ROWS).numpy().view(np.uint32)
    assert np.array_equal(got, want)
    assert (got == (0 if n else 1)).all()


def test_chained_step_first_call_equals_k1_plain():
    from sourmash_tpu_torch.tools import profile_sketch_chain as chain

    rows = torch.from_numpy(_rows(31, np.random.default_rng(5)))
    x1, cnt = chain.step_full(rows, MH1000)
    want = cs.survivor_slots_plain(rows, MH1000, ksize=31, slots=4)
    assert torch.equal(cnt, want[2])
    assert torch.equal(x1, rows ^ (int(want[2][0, 0]) & 3))
    _n, R, _ = cs.geometry(rows.shape[1], 31)
    out = cs.slots_outputs(2, R, 4, rows.device)
    x2, cnt2 = chain.kernel_step(out, MH1000)(rows)
    for g, w in zip(out, want):
        assert torch.equal(g, w)
    assert cnt2 is out[2] and torch.equal(x2, rows ^ (int(want[0][0, 0, 0]) & 0xFF))


@pytest.mark.parametrize("tool,argv", [
    ("exp_split_kernel", ["check"]), ("exp_v2_kernel", ["time"]),
    ("profile_sketch_parts", ["murmur"]), ("profile_sketch_chain", ["full"]),
])
def test_tools_without_cuda_raise(tool, argv, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    mod = importlib.import_module(f"sourmash_tpu_torch.tools.{tool}")
    monkeypatch.delenv("SOURMASH_TORCH_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)


def test_tools_refuse_unknown_modes(monkeypatch):
    from sourmash_tpu_torch.tools import profile_sketch_chain, profile_sketch_parts

    monkeypatch.setenv("SOURMASH_TORCH_DEVICE", "cpu")
    with pytest.raises(SystemExit, match="no counterpart in the port"):
        profile_sketch_chain.main(["rows256"])
    with pytest.raises(SystemExit, match="unknown mode"):
        profile_sketch_parts.main(["mulx"])


def test_wrappers_check_their_inputs():
    rows = torch.zeros((1, 200), dtype=torch.uint8)
    words, valid = csp.split_words(rows, ksize=31)
    with pytest.raises(TypeError):
        csp.split_slots(words.to(torch.int32), valid, MH1000, ksize=31)
    with pytest.raises(TypeError):
        csp.split_slots(words, valid, MH1000, ksize=41)  # 6 words a window, not 4
    with pytest.raises(TypeError):
        csp.murmur_only(torch.zeros((ROWS + EXTRA + 1, LANES), dtype=torch.int32), rows=ROWS)
    with pytest.raises(TypeError):
        csp.mulchain(torch.zeros((ROWS + EXTRA, LANES), dtype=torch.int64), 1, rows=ROWS)
    with pytest.raises(TypeError):
        cs.survivor_slots(rows, MH1000, ksize=31, slots=4,
                          out=cs.slots_outputs(1, 2, 8, rows.device))
    meta = torch.zeros((1, 200), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        csp.survivor_slots_v2(meta, MH1000, ksize=31)


# -- the tile designs of split_words and assembly_only, emulated --------------

TILE, KTILE = 1024, 256  # windows a block stages, threads a block (sketch_common.cuh)
ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
M32 = np.uint64(0xFFFFFFFF)


def _comp(c):
    "The kernels' complement of any bytes: c ^ 4 when bit 1 of c is set, else c ^ 21."
    c = np.asarray(c, dtype=np.uint32)
    return c ^ np.where(c & 2, 4, 21).astype(np.uint32)


def _staged_len(k):
    return (TILE + k - 1 + 31) // 32 * 32


def _low_bytes(x, n):
    return x if n >= 8 else x & np.uint64((1 << (8 * n)) - 1)


def _load8(w32, pos):
    "load8: eight bytes from any offset, three aligned 32-bit loads and two funnel shifts."
    p, sh = pos >> 2, 8 * (pos & 3)
    return (_funnel_r(w32[p + 1], w32[p + 2], sh) << np.uint64(32)) | _funnel_r(
        w32[p], w32[p + 1], sh)


def _strand8(w32, L, s, k):
    """strand8: eight bytes of the forward run (at s) and of the rc run (at
    2L - s - k) a step, the first differing step decides by its byte-swapped
    words. Returns (rev, the step that decided; for a palindrome, which
    takes the forward strand, the number of steps)."""
    r = 2 * L - s - k
    rev = np.zeros(s.size, dtype=bool)
    step = np.full(s.size, -(-k // 8))
    for c in range(0, k, 8):
        x = _low_bytes(_load8(w32, s + c), k - c)
        y = _low_bytes(_load8(w32, r + c), k - c)
        now = (step > c // 8) & (x != y)
        rev = np.where(now, y.byteswap() < x.byteswap(), rev)
        step[now] = c // 8
    return rev, step


def _run_words(w32, off, k, nw):
    "run_word for c < nw: eight-byte loads of the chosen run, masked to k bytes; 0 past it."
    return [_low_bytes(_load8(w32, off + 8 * c), k - 8 * c) if 8 * c < k
            else np.zeros(off.size, np.uint64) for c in range(nw)]


def _split_words_tiles(rows, k):
    """split_words_kernel in numpy, tile by tile: K2's tile; plane_strand for
    every window, strand8 for one holding a byte that is not ACGT; the words
    eight-byte loads of the chosen run; each set of 256 windows (window
    j * 256 + t of thread t) put in the staging area at t * nw and copied
    out as one contiguous run of the output. An index past the staged
    bytes' reach raises. Returns (words [B, n_pad, nw] uint64, valid,
    the deepest strand8 step taken)."""
    B, S = rows.shape
    _n, _R, n_pad = cs.geometry(S, k)
    nw = csp.n_words(k)
    L = _staged_len(k)
    out = np.zeros(B * n_pad * nw, dtype=np.uint64)
    valid = np.zeros(B * n_pad, dtype=np.uint8)
    deepest = -1
    for b in range(B):
        for w0 in range(0, n_pad, TILE):
            p = w0 + np.arange(L)
            fwd = np.zeros(L, dtype=np.uint32)
            fwd[p < S] = rows[b, p[p < S]]
            w32, planes = _dna_tile(fwd)
            for j in range(TILE // KTILE):
                first = b * n_pad + w0 + j * KTILE
                in_set = min(KTILE, n_pad - (w0 + j * KTILE))
                if in_set <= 0:
                    break
                s = j * KTILE + np.arange(KTILE)
                ok, rev = _plane_strand(planes, L, s, k)
                byte_rev, step = _strand8(w32, L, s[~ok], k)
                rev[~ok] = byte_rev
                deepest = max(deepest, int(step.max(initial=-1)))
                off = np.where(rev, 2 * L - s - k, s)
                staged = np.stack(_run_words(w32, off, k, nw), axis=1).ravel()
                valid[first : first + in_set] = ok[:in_set]
                out[first * nw : (first + in_set) * nw] = staged[: in_set * nw]
    return out.reshape(B, n_pad, nw), valid.reshape(B, n_pad), deepest


def _value_tile(vals, w0, k):
    """stage_value_tile over one block's int32 values: quads of four values
    (16-byte loads, zero past the block), each the forward word of their
    low bytes, the rc word (byte-reversed, complemented, at quads - 1 - q)
    and a nibble of the not-ACGT plane, eight nibbles a plane word."""
    L = _staged_len(k)
    quads = L // 4
    q = np.arange(quads)
    idx = w0 + 4 * q[:, None] + np.arange(4)
    inside = (w0 + 4 * q < vals.size)[:, None]
    b = np.where(inside, vals[np.minimum(idx, vals.size - 1)], 0).astype(np.uint32) & 0xFF
    f = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)
    rc = _comp(np.stack([b[:, 3], b[:, 2], b[:, 1], b[:, 0]], axis=1))
    rcw = (rc[:, 0] | (rc[:, 1] << 8) | (rc[:, 2] << 16) | (rc[:, 3] << 24))[::-1]
    nb = (~np.isin(b, ACGT)).astype(np.uint32) << np.arange(4, dtype=np.uint32)
    nib = nb.sum(axis=1, dtype=np.uint32).reshape(-1, 8) << (4 * np.arange(8, dtype=np.uint32))
    bad = np.r_[nib.sum(axis=1, dtype=np.uint32), np.uint32(0)].astype(np.uint32)
    w32 = np.r_[f, rcw, np.zeros(4, np.uint32)].astype(np.uint32)
    return w32, bad


def _assembly_only_tiles(blocks, rows):
    """assembly_only_kernel in numpy, tile by tile: T4's tile staged from the
    values; validity a funnel shift of the plane; every window's strand
    from strand8; its words eight-byte loads of the chosen run, XORed and
    folded to 32 bits, xor validity. Returns (out [nblk * rows, 128]
    uint32, the deepest strand8 step taken)."""
    k = csp.T4_KSIZE
    per, V = rows * LANES, (rows + EXTRA) * LANES
    L = _staged_len(k)
    vals = blocks.reshape(-1, V)
    out = np.zeros((vals.shape[0], per), dtype=np.uint32)
    deepest = -1
    for blk, v in enumerate(vals):
        for w0 in range(0, per, TILE):
            w32, bad = _value_tile(v, w0, k)
            s = np.arange(TILE)
            ok = (_plane_bits(bad, s) & np.uint64((1 << k) - 1)) == 0
            rev, step = _strand8(w32, L, s, k)
            deepest = max(deepest, int(step.max()))
            off = np.where(rev, 2 * L - s - k, s)
            x = np.bitwise_xor.reduce(np.stack(_run_words(w32, off, k, csp.n_words(k))), axis=0)
            res = ((x >> np.uint64(32)) ^ (x & M32) ^ ok).astype(np.uint32)
            keep = w0 + s < per
            out[blk, w0 + s[keep]] = res[keep]
    return out.reshape(-1, LANES), deepest


def _palindromes(seq, rng, k, count, alphabet):
    """Write `count` palindromes of bytes from `alphabet` (under the kernels'
    complement, which takes any byte) into seq: k-long at even k; at odd k
    a k-mer Q x comp(Q)[::-1], equal to its reverse complement but for x."""
    for start in rng.integers(0, seq.size - k, size=count):
        half = rng.choice(alphabet, size=k // 2)
        mirror = _comp(half)[::-1].astype(np.uint8)
        mid = rng.choice(alphabet, size=k % 2)
        seq[start : start + k] = np.r_[half, mid, mirror]


def _n_runs(seq, rng, k, bounds):
    "N runs of 1 to k + 2 bases that start, end or sit across each position of `bounds`."
    for at in bounds:
        length = int(rng.integers(1, k + 3))
        start = int(at) - int(rng.integers(0, length + k))
        seq[max(start, 0) : max(start + length, 0)] = ord("N")


def _edge_seq(kind, size, k, rng, windows):
    """size bytes of one kind: random bytes (all 256 values); ACGT with 2 %
    random bytes; ACGT with N runs across the 128- and 1,024-window
    boundaries of `windows` windows; ACGT and random-byte palindromes (k
    and k +- 1 long); ACGT ending in a zero tail that reaches the windows."""
    seq = rng.choice(ACGT, size=size)
    if kind == "random bytes":
        return rng.integers(0, 256, size=size, dtype=np.uint8)
    if kind == "acgt 2%":
        hit = rng.random(size) < 0.02
        seq[hit] = rng.integers(0, 256, size=int(hit.sum()), dtype=np.uint8)
    elif kind == "N runs":
        _n_runs(seq, rng, k, [*range(128, windows, 128), *range(TILE, windows, TILE)])
    elif kind == "palindromes":
        for kk in (k - 1, k, k + 1):
            _palindromes(seq, rng, kk, size // 200, ACGT)
            _palindromes(seq, rng, kk, size // 400, np.arange(256, dtype=np.uint8))
    elif kind == "zero tail":
        seq[windows - 150 :] = 0
    return seq


T4_KINDS = ["random bytes", "acgt 2%", "N runs", "palindromes", "zero tail"]


def _t4_edge_blocks(kind, rows, nblk, seed):
    rng = np.random.default_rng(seed)
    V = (rows + EXTRA) * LANES
    seqs = [_edge_seq(kind, V, csp.T4_KSIZE, rng, rows * LANES) for _ in range(nblk)]
    return np.concatenate(seqs).astype(np.int32).reshape(-1, LANES)


@pytest.mark.parametrize("kind", T4_KINDS)
def test_assembly_only_tile_design_matches_pallas_body(kind, t4):
    """assembly_only's tile design (int32 staging in quads, the rc run, the
    not-ACGT plane, strand8 for every window, eight-byte words of the
    chosen run) equals the JAX tool's `_assembly_only_kernel` in interpret
    mode and the plain version at rows = 8, on every kind of edge input."""
    pp, _ = t4
    blocks = _t4_edge_blocks(kind, ROWS, 3, seed=T4_KINDS.index(kind))
    got, deepest = _assembly_only_tiles(blocks, ROWS)
    want = _t4_jax(functools.partial(pp._assembly_only_kernel, interpret=True), blocks)
    assert np.array_equal(got, want)
    plain = csp.assembly_only(torch.from_numpy(blocks), rows=ROWS).numpy().view(np.uint32)
    assert np.array_equal(got, plain)
    if kind == "palindromes":  # windows that share 8 bytes with their reverse complement
        assert deepest >= 1


@pytest.mark.parametrize("kind,rows", [(kind, r) for r in (9, 16) for kind in T4_KINDS])
def test_assembly_only_tile_design_matches_plain(kind, rows):
    """The same at rows = 9 (a block ends mid-tile: its second tile's 128
    windows are the only ones stored) and rows = 16 (two whole tiles)."""
    blocks = _t4_edge_blocks(kind, rows, 2, seed=10 * rows + T4_KINDS.index(kind))
    got, _ = _assembly_only_tiles(blocks, rows)
    plain = csp.assembly_only(torch.from_numpy(blocks), rows=rows).numpy().view(np.uint32)
    assert got.shape == plain.shape and np.array_equal(got, plain)


def _t2_edge_rows(kind, k, rng):
    """[4, S] rows over three 1,024-window tiles: "edges" are random bytes,
    ACGT with 2 % random bytes, ACGT with N runs across the 128- and
    1,024-window boundaries, and the same ending in a zero tail;
    "palindromes" ACGT and random-byte palindromes, and a zero tail."""
    S = 2 * TILE + 300 + k
    n = S - k + 1
    kinds = (["random bytes", "acgt 2%", "N runs", "N runs"] if kind == "edges"
             else ["palindromes"] * 4)
    rows = np.stack([_edge_seq(kd, S, k, rng, n) for kd in kinds])
    rows[3, S - 200 :] = 0
    return rows


@pytest.mark.parametrize("kind,k", [("edges", 21), ("edges", 31), ("edges", 33),
                                    ("palindromes", 32)])
def test_split_words_tile_design_matches_pallas_body(kind, k, tools):
    """split_words' tile design (K2's tile and plane strand, strand8 for a
    window holding a byte that is not ACGT, eight-byte words of the chosen
    run, each set of 256 windows copied out through the staging area)
    equals the JAX tool's `_assembly_kernel` in interpret mode and the
    plain version on every window, invalid and pad windows included."""
    sp = tools["exp_split_kernel"]
    rows = _t2_edge_rows(kind, k, np.random.default_rng(2000 + k))
    B = rows.shape[0]
    words, valid, deepest = _split_words_tiles(rows, k)
    pw, pv = csp.split_words(torch.from_numpy(rows), ksize=k)
    assert np.array_equal(words, u64.to_numpy(pw)) and np.array_equal(valid, pv.numpy())
    blocks, nblocks = _tool_blocks(rows, k)
    nw = csp.n_words(k)
    outs = _call(functools.partial(sp._assembly_kernel, ksize=k, rows=ROWS, interpret=True),
                 2 * nw + 1, [jnp.asarray(blocks)], [_in_spec()], B * nblocks)
    n_pad = words.shape[1]
    for w in range(nw):
        lo_w = _flat(outs[2 * w], B)[:, :n_pad].astype(np.uint64)
        hi_w = _flat(outs[2 * w + 1], B)[:, :n_pad].astype(np.uint64)
        assert np.array_equal(words[:, :, w], (hi_w << np.uint64(32)) | lo_w), w
    assert np.array_equal(valid, _flat(outs[-1], B)[:, :n_pad].astype(np.uint8))
    assert valid.any() and not valid.all()
    if kind == "palindromes":  # an invalid palindrome runs strand8 to its end
        assert deepest == -(-k // 8)


# -- T3's tile design and the mul-chain's mapping, emulated -------------------


def _v2_tiles(rows, k, max_hash, slots):
    """survivor_slots_v2_kernel in numpy, block by block: K2's tile; each
    thread's four windows (window j of thread t at tile position
    j * 256 + t) finished one at a time: validity and strand from the
    planes, murmur of a valid window only (an invalid one keeps hash 0),
    the threshold; then write_segment_slots<4>: window j of thread t in
    segment 8 * block + 2j + t // 128, ranked by lane among the segment's
    survivors, the first `slots` written, the rest of the slots 0, the TRUE
    count; a segment >= R is not written. An index past the staged bytes'
    reach raises, as does an output written other than once. Returns
    (hi, lo, counts) as K1's int32 tensors and the number of windows
    hashed."""
    B, S = rows.shape
    n, R, _ = cs.geometry(S, k)
    L = _staged_len(k)
    hi = np.zeros((B, R, slots), dtype=np.uint32)
    lo = np.zeros((B, R, slots), dtype=np.uint32)
    counts = np.zeros((B, R), dtype=np.int32)
    written = np.zeros((B, R, slots + 1), dtype=np.int32)
    hashed = 0
    for b in range(B):
        for blk in range(-(-R // 8)):
            w0 = blk * TILE
            p = w0 + np.arange(L)
            fwd = np.zeros(L, dtype=np.uint32)
            fwd[p < S] = rows[b, p[p < S]]
            w32, planes = _dna_tile(fwd)
            keep = np.zeros((TILE // KTILE, KTILE), dtype=bool)
            hash_ = np.zeros((TILE // KTILE, KTILE), dtype=np.uint64)
            for j in range(TILE // KTILE):  # one window a thread at a time
                s = j * KTILE + np.arange(KTILE)
                ok, rev = _plane_strand(planes, L, s, k)
                off = np.where(rev, 2 * L - s - k, s)
                if ok.any():
                    hash_[j, ok] = _funnel_murmur(w32, off[ok], k)
                hashed += int(ok.sum())
                keep[j] = ok & (w0 + s < n) & (hash_[j] <= np.uint64(max_hash))
            for j in range(TILE // KTILE):
                for half in range(KTILE // cs.SEG):
                    seg = blk * 8 + 2 * j + half
                    if seg >= R:
                        continue
                    kp = keep[j, half * cs.SEG : (half + 1) * cs.SEG]
                    h = hash_[j, half * cs.SEG : (half + 1) * cs.SEG]
                    rank = np.cumsum(kp) - kp
                    total = int(kp.sum())
                    for r in np.flatnonzero(kp & (rank < slots)):
                        hi[b, seg, rank[r]] = h[r] >> np.uint64(32)
                        lo[b, seg, rank[r]] = h[r] & M32
                        written[b, seg, rank[r]] += 1
                    written[b, seg, total:slots] += 1  # zeros
                    counts[b, seg] = total
                    written[b, seg, slots] += 1
    assert (written == 1).all()
    return (torch.from_numpy(hi.view(np.int32)), torch.from_numpy(lo.view(np.int32)),
            torch.from_numpy(counts)), hashed


def _t3_edge_rows(k, rng):
    """[4, S] rows over three 1,024-window tiles: ACGT with 2 % random
    bytes, N runs across the 128- and 1,024-window boundaries, ACGT and
    random-byte palindromes, and N runs ending in a zero tail; rows 0 and 2
    hold a tandem repeat whose k-mer survives max_hash / 1000, across
    segment boundaries and (row 2) the first tile boundary, which
    overflows the slots."""
    S = 2 * TILE + 300 + k
    n = S - k + 1
    rows = np.stack([_edge_seq(kind, S, k, rng, n)
                     for kind in ("acgt 2%", "N runs", "palindromes", "N runs")])
    rows[3, S - 200 :] = 0
    rep = _tandem_repeat(k, rng)
    rows[0, 300:700] = rep
    rows[2, 900:1300] = rep
    return rows


@pytest.mark.parametrize("k", [21, 31, 33, 51])
def test_v2_tile_design_matches_pallas_body_and_k1(k, tools):
    """T3's design (K2's tile and plane strand, each thread's windows
    finished one at a time, only valid windows hashed, K1's segment order)
    equals the JAX tool's `_slots_kernel_v2` in interpret mode (counts and
    used slots; its unused slots hold the segment's sum of hash halves),
    K1's plain version and the port's survivor_slots_v2, at max_hash / 1000
    and 2^64 - 1, with overflowing segments."""
    v2 = tools["exp_v2_kernel"]
    rows = _t3_edge_rows(k, np.random.default_rng(3000 + k))
    B = rows.shape[0]
    t = torch.from_numpy(rows)
    hashes, valid = cs.window_hashes(t, ksize=k)
    hashes, valid = u64.to_numpy(hashes), valid.numpy()
    blocks, nblocks = _tool_blocks(rows, k)
    for mh in (MH1000, MAX_U64):
        slots = 4 if mh == MH1000 else 8
        got, hashed = _v2_tiles(rows, k, mh, slots)
        assert hashed == int(valid.sum()) and hashed < valid.size
        packed = _call(
            functools.partial(v2._slots_kernel_v2, ksize=k, rows=ROWS, slots=slots,
                              interpret=True), 1,
            [_mh_pair(mh), jnp.asarray(blocks)], [_smem_spec(), _in_spec()], B * nblocks)
        _check_packed(np.asarray(packed), got, hashes, slots)
        for g, w, p in zip(got, cs.survivor_slots_plain(t, mh, ksize=k, slots=slots),
                           csp.survivor_slots_v2(t, mh, ksize=k, slots=slots)):
            assert torch.equal(g, w) and torch.equal(g, p)


@pytest.mark.parametrize("k", [7, 63, 129])
def test_v2_tile_design_matches_plain(k):
    """The same at run-time k (the kernel's kK = 0): 7, and 63 and 129,
    whose strand takes two and five 32-base plane steps, with a row of
    uniformly random bytes in place of the N runs ending in a zero tail."""
    rows = _t3_edge_rows(k, np.random.default_rng(4000 + k))
    rows[3] = np.random.default_rng(k).integers(0, 256, size=rows.shape[1], dtype=np.uint8)
    t = torch.from_numpy(rows)
    for mh in (MH1000, MAX_U64):
        slots = 4 if mh == MH1000 else 8
        got, _ = _v2_tiles(rows, k, mh, slots)
        for g, w in zip(got, cs.survivor_slots_plain(t, mh, ksize=k, slots=slots)):
            assert torch.equal(g, w)
        assert (got[2] > slots).any()


MUL_CHAINS = 4  # csrc/sketch_parts.cu kMulChains


def _rotl(x, r):
    return (x << np.uint64(r)) | (x >> np.uint64(64 - r))


def _four_a_thread(blocks, rows, chains):
    """A kernel of T4's layout that takes four values a thread, in numpy
    (murmur_only, mulchain, int_probe): thread g of a grid of ceil(rows *
    32 / 256) blocks of 256 a block of values takes the four values at 4g..
    (one 16-byte load) and stores `chains` of them (uint64 [..., 4] ->
    uint64 [..., 4] of u32 values) at 4g.. of the block's output (one
    16-byte store); a thread with 4g >= rows * 128 exits. Raises unless
    every output is written once."""
    V, per = (rows + EXTRA) * LANES, rows * LANES
    vals = (blocks.reshape(-1, V).astype(np.int64) & 0xFFFFFFFF).astype(np.uint64)
    out = np.zeros((vals.shape[0], per), dtype=np.uint64)
    written = np.zeros(out.shape, dtype=np.int32)
    groups = per // MUL_CHAINS
    for bx in range(-(-groups // KTILE)):
        g = bx * KTILE + np.arange(KTILE)
        at = MUL_CHAINS * g[g < groups, None] + np.arange(MUL_CHAINS)
        out[:, at] = chains(vals[:, at])
        written[:, at] += 1
    assert (written == 1).all()
    return out.astype(np.uint32).reshape(-1, LANES)


def _mulchain_groups(blocks, rows, n_rounds):
    """mulchain_kernel in numpy (`_four_a_thread`): the four values' chains
    run round by round, interleaved."""

    def chains(x):
        v = (x << np.uint64(32)) | (x ^ np.uint64(1))
        for _ in range(n_rounds):
            for c in range(MUL_CHAINS):  # the chains interleaved round by round
                r = _rotl(v[..., c] * np.uint64(C1), 31)
                v[..., c] = r ^ _rotl(r, 32)
        return (v >> np.uint64(32)) ^ (v & M32)

    return _four_a_thread(blocks, rows, chains)


@pytest.mark.parametrize("rows,n", [(r, n) for r in (9, 16) for n in (0, 1, 16)])
def test_mulchain_groups_match_pallas_body(rows, n, t4, monkeypatch):
    """mulchain's mapping (four consecutive values a thread, the chains
    interleaved, one 16-byte load and store) equals the JAX tool's
    `_mulchain_kernel` in interpret mode and the plain version at rows = 9
    (a part grid block of threads) and 16, on values of the whole int32
    range; 1 everywhere at 0 rounds, 0 after."""
    pp, _ = t4
    monkeypatch.setattr(pp, "ROWS", rows)
    blocks = np.random.default_rng(50 + rows).integers(
        -(2**31), 2**31, size=(3 * (rows + EXTRA), LANES)).astype(np.int32)
    got = _mulchain_groups(blocks, rows, n)
    want = np.asarray(pl.pallas_call(
        functools.partial(pp._mulchain_kernel, n_rounds=n), grid=(3,),
        in_specs=[pl.BlockSpec((rows + EXTRA, LANES), lambda b: (b, np.int32(0)))],
        out_specs=pl.BlockSpec((rows, LANES), lambda b: (b, np.int32(0))),
        out_shape=jax.ShapeDtypeStruct((3 * rows, LANES), jnp.uint32), interpret=True,
    )(jnp.asarray(blocks)))
    assert np.array_equal(got, want)
    plain = csp.mulchain(torch.from_numpy(blocks), n, rows=rows).numpy().view(np.uint32)
    assert np.array_equal(got, plain)
    assert (got == (0 if n else 1)).all()


# -- murmur_only on K1's k = 31 body, and the integer-pipe probe --------------


def _fmix64(k):
    k ^= k >> np.uint64(33)
    k *= np.uint64(0xFF51AFD7ED558CCD)
    k ^= k >> np.uint64(33)
    k *= np.uint64(0xC4CEB9FE1A85EC53)
    return k ^ (k >> np.uint64(33))


def _murmur31_fake(x):
    """murmur_only_kernel<31>'s body in numpy: murmur (seed 42) of 31 bytes
    given as the fake words (x ^ 2i) << 32 | (x ^ (2i + 1)), unmasked, with
    k = 31 folded (one 16-byte block, a 15-byte tail: word 3 into h2, word
    2 into h1); then hi ^ lo."""

    def word(i):
        return ((x ^ np.uint64(2 * i)) << np.uint64(32)) | (x ^ np.uint64(2 * i + 1))

    def mix1(k):
        return _rotl(k * np.uint64(C1), 31) * np.uint64(C2)

    def mix2(k):
        return _rotl(k * np.uint64(C2), 33) * np.uint64(C1)

    h1 = np.full_like(x, 42) ^ mix1(word(0))
    h1 = (_rotl(h1, 27) + np.uint64(42)) * np.uint64(5) + np.uint64(0x52DCE729)
    h2 = np.full_like(x, 42) ^ mix2(word(1))
    h2 = (_rotl(h2, 31) + h1) * np.uint64(5) + np.uint64(0x38495AB5)
    h2 ^= mix2(word(3))
    h1 ^= mix1(word(2))
    h1 ^= np.uint64(31)
    h2 ^= np.uint64(31)
    h1 += h2
    h2 += h1
    h = _fmix64(h1) + _fmix64(h2)
    return (h >> np.uint64(32)) ^ (h & M32)


@pytest.mark.parametrize("rows", [9, 16])
def test_murmur_only_matches_pallas_body_at_rows(rows, t4, monkeypatch):
    """murmur_only's design (four consecutive values a thread, the k = 31
    body folded, `_four_a_thread` of `_murmur31_fake`) and its plain
    version equal the JAX tool's `_murmur_only_kernel` in interpret mode at
    rows = 9 (a part grid block of threads) and 16, on values of the whole
    int32 range."""
    pp, _ = t4
    monkeypatch.setattr(pp, "ROWS", rows)
    blocks = np.random.default_rng(60 + rows).integers(
        -(2**31), 2**31, size=(3 * (rows + EXTRA), LANES)).astype(np.int32)
    want = np.asarray(pl.pallas_call(
        pp._murmur_only_kernel, grid=(3,),
        in_specs=[pl.BlockSpec((rows + EXTRA, LANES), lambda b: (b, np.int32(0)))],
        out_specs=pl.BlockSpec((rows, LANES), lambda b: (b, np.int32(0))),
        out_shape=jax.ShapeDtypeStruct((3 * rows, LANES), jnp.uint32), interpret=True,
    )(jnp.asarray(blocks)))
    assert np.array_equal(_four_a_thread(blocks, rows, _murmur31_fake), want)
    got = csp.murmur_only(torch.from_numpy(blocks), rows=rows)
    assert got.shape == (3 * rows, LANES) and got.dtype == torch.int32
    assert np.array_equal(got.numpy().view(np.uint32), want)
    assert len(np.unique(want)) == want.size  # no two values share a hash here


def _probe_chains(mode, n_rounds):
    """int_probe_kernel<mode>'s rounds in numpy on the four values of a
    thread: v = x << 32 | (x * c mod 2^32), n_rounds rounds, then hi ^ lo."""
    c, c2 = np.uint64(int(C1) & 0xFFFFFFFF), np.uint64((int(C1) >> 32) ^ 1)  # c2 even

    def chains(x):
        hi, lo = x.copy(), (x * c) & M32
        for _ in range(n_rounds):
            if mode in ("mul64", "mix"):
                v = ((hi << np.uint64(32)) | lo) * np.uint64(C1)
                hi, lo = v >> np.uint64(32), v & M32
            if mode == "mul32":
                hi, lo = (hi * c2 + lo) & M32, (lo * c + hi) & M32
            if mode in ("alu", "mix"):
                v = _rotl((hi << np.uint64(32)) | lo, 31)
                lo = v & M32
                hi = (v >> np.uint64(32)) ^ lo
        return hi ^ lo

    return chains


@pytest.mark.parametrize("mode,n", [(m, n) for m in ("mul64", "mul32", "alu", "mix")
                                    for n in (0, 1, 16, 64)])
def test_int_probe_plain_matches_numpy(mode, n):
    """The integer-pipe probe's plain version equals its rounds in numpy
    uint64 arithmetic (`_probe_chains` over `_four_a_thread`) at rows = 9
    (a part grid block of threads), on values of the whole int32 range; no
    mode's output is constant after a round."""
    rows = 9
    blocks = np.random.default_rng(70 + n).integers(
        -(2**31), 2**31, size=(2 * (rows + EXTRA), LANES)).astype(np.int32)
    want = _four_a_thread(blocks, rows, _probe_chains(mode, n))
    got = csp.int_probe(torch.from_numpy(blocks), mode, n, rows=rows)
    assert got.shape == (2 * rows, LANES) and got.dtype == torch.int32
    assert np.array_equal(got.numpy().view(np.uint32), want)
    assert len(np.unique(want)) > want.size // 2


def test_murmur_only_and_probe_refuse_unaligned_blocks():
    """murmur_only and int_probe read four values a load: blocks 4 bytes off
    a 16-byte boundary raise TypeError, on a CPU tensor too (the aligned
    ones go through); an unknown probe mode or negative rounds raise
    ValueError."""
    n = (ROWS + EXTRA) * LANES
    buf = torch.zeros(n + 4, dtype=torch.int32)
    aligned, offset = buf[:n].view(ROWS + EXTRA, LANES), buf[1 : n + 1].view(ROWS + EXTRA, LANES)
    assert aligned.data_ptr() % 16 == 0 and offset.data_ptr() % 16 == 4
    with pytest.raises(TypeError, match="16-byte aligned"):
        csp.murmur_only(offset, rows=ROWS)
    with pytest.raises(TypeError, match="16-byte aligned"):
        csp.int_probe(offset, "mul64", 1, rows=ROWS)
    assert csp.murmur_only(aligned, rows=ROWS).shape == (ROWS, LANES)
    assert csp.int_probe(aligned, "mix", 2, rows=ROWS).shape == (ROWS, LANES)
    with pytest.raises(ValueError, match="unknown probe mode"):
        csp.int_probe(aligned, "mul16", 1, rows=ROWS)
    with pytest.raises(ValueError, match="n_rounds"):
        csp.int_probe(aligned, "alu", -1, rows=ROWS)


def test_profile_tool_probe_modes(monkeypatch):
    """The port's T4 tool names the probe's modes probe-MODE-N (mulN stays
    the mul-chain) and refuses others."""
    from sourmash_tpu_torch.tools import profile_sketch_parts as tool

    assert tool.variant("probe-alu-16")[1] == "probe-alu-16"
    assert tool.probe_mode("probe-mix-256") == ("mix", 256)
    assert tool.variant("mul64")[1] == "mulchain-64"
    for bad in ("probe-mul65-1", "probe-mul64", "probe-alu-x", "probe-alu-1-2"):
        assert tool.variant(bad) is None
    monkeypatch.setenv("SOURMASH_TORCH_DEVICE", "cpu")
    with pytest.raises(SystemExit, match="unknown mode"):
        tool.main(["probe-alu"])
