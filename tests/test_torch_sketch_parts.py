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
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    while True:
        unit = rng.choice(acgt, size=int(rng.integers(6, 15)))
        h, valid = dna_hashes(np.tile(unit, (k + 30) // len(unit) + 1), k, 42)
        if (valid & (h <= np.uint64(MH1000))).any():
            break
    rep = np.tile(unit, 400 // len(unit) + 1)[:400]
    rows[0, 300:700] = rep
    rows[1, S - 250 :] = 0
    return rows


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
