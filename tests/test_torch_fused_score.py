"""The fused triangular score kernel's plain versions held against the JAX
package's Pallas kernels (interpret mode) and its jnp oracle, on the cases of
``tests/test_fused_score.py``: odd p, several sample chunk widths, dead rows
holding NaN, masks and ``n_valid`` padding; and the batched entry
(``fused_score_batch``) on ragged buckets with one valid count per dataset,
against ``repro.kernels.fused_score.fused_score_batch``. The wrappers' input
checks run here too; the kernel itself runs only on the card
(``test_torch_cuda.py``).

Tolerance: a live score may differ by 1e-3 of the largest score of its
case. Both sides take the same float32 formulas and differ only in the order
of the sample and tile sums. Each stat I_ij (~1e-3 on this Gaussian data) is
a difference of entropies near 1.42 whose float32 rounding (~1e-7) is ~1e-4
of I, so S = sum min(0, I)^2 (1e-7..1e-5 here) carries ~2e-4 of its scale:
the largest difference measured on these cases is 2.9e-4 of the largest
score. A fixed atol would exceed the scores themselves.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core.covariance import cov_matrix, normalize  # noqa: E402
from repro.core.pairwise import fused_scores as j_fused_scores  # noqa: E402
from repro.kernels.fused_score import fused_score_batch as j_batch_kernel  # noqa: E402
from repro.kernels.fused_score import fused_score_vector as j_kernel  # noqa: E402
from repro_torch import measure  # noqa: E402
from repro_torch.core.pairwise import fused_layout as t_layout  # noqa: E402
from repro_torch.kernels import fused_score as fs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

#: Largest score difference allowed, as a share of the case's largest score.
SCORE_SHARE = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _setup(p, n, seed=0):
    rng = np.random.default_rng(seed)
    xn = jax.jit(normalize)(jnp.asarray(rng.standard_normal((p, n)), jnp.float32))
    c = jax.jit(cov_matrix)(xn)
    return np.array(xn), np.array(c), np.ones((p,), bool)


def _port(xn, c, mask, **kw):
    return fs.fused_score_vector(torch.from_numpy(xn), torch.from_numpy(c),
                                 torch.from_numpy(mask), **kw).numpy()


def _close(a, b, sel=slice(None)):
    """Equal +inf pattern; finite scores within SCORE_SHARE of the largest."""
    a, b = np.asarray(a, np.float64)[sel], np.asarray(b, np.float64)[sel]
    np.testing.assert_array_equal(np.isinf(a), np.isinf(b))
    live = np.isfinite(b)
    scale = np.abs(b[live]).max()
    assert scale > 0, "every reference score is zero: the comparison is empty"
    np.testing.assert_allclose(a[live], b[live], rtol=0, atol=SCORE_SHARE * scale)


@pytest.mark.parametrize("p,n", [(8, 512), (20, 600), (33, 700), (7, 130)])
def test_plain_matches_pallas_kernel(p, n):
    """Odd p, n not a multiple of the 512-sample chunk."""
    xn, c, mask = _setup(p, n, seed=p * 1000 + n)
    s_k = j_kernel(jnp.asarray(xn), jnp.asarray(c), jnp.asarray(mask),
                   block=8, block_n=512, interpret=True)
    _close(_port(xn, c, mask), s_k)


@pytest.mark.parametrize("block,block_n", [(8, 128), (8, 256), (16, 512)])
def test_plain_matches_pallas_block_shapes(block, block_n):
    """The Pallas kernel's sample chunk width changes only its sum order;
    the port's chunk width is fixed (``fused_score.BLOCK_N``)."""
    xn, c, mask = _setup(24, 640, seed=3)
    s_k = j_kernel(jnp.asarray(xn), jnp.asarray(c), jnp.asarray(mask),
                   block=block, block_n=block_n, interpret=True)
    _close(_port(xn, c, mask, block=block), s_k)


@pytest.mark.parametrize("p,n,block", [(8, 512, 8), (33, 700, 16), (17, 300, 32)])
def test_plain_matches_jnp_oracle(p, n, block):
    xn, c, mask = _setup(p, n, seed=p + block)
    s_o = j_fused_scores(jnp.asarray(xn), jnp.asarray(c), jnp.asarray(mask),
                         block=block)
    _close(_port(xn, c, mask, block=block), s_o)


def _dead_row_case():
    p, n = 16, 700
    xn, c, _ = _setup(p, n, seed=11)
    xn[3, :] = np.nan
    c[3, :] = np.nan
    c[:, 3] = np.nan
    mask = np.ones((p,), bool)
    mask[3] = False
    return xn, c, mask


def test_dead_row_nonfinite_data():
    """Dead rows may hold NaN; the select keeps it out of live scores."""
    xn, c, mask = _dead_row_case()
    s_t = _port(xn, c, mask)
    s_k = j_kernel(jnp.asarray(xn), jnp.asarray(c), jnp.asarray(mask),
                   block=8, interpret=True)
    s_o = j_fused_scores(jnp.asarray(xn), jnp.asarray(c), jnp.asarray(mask), block=8)
    assert np.all(np.isfinite(s_t[mask])) and s_t[3] == np.inf
    _close(s_t, s_k, mask)
    _close(s_t, s_o, mask)


def test_respects_mask():
    p, n = 16, 700
    xn, c, _ = _setup(p, n, seed=11)
    mask = np.arange(p) % 3 != 0
    s_t = _port(xn, c, mask)
    s_k = j_kernel(jnp.asarray(xn), jnp.asarray(c), jnp.asarray(mask),
                   block=8, interpret=True)
    assert np.all(s_t[~mask] == np.inf)
    _close(s_t, s_k)


def test_n_valid_padding():
    """Zero-padded sample columns change nothing but the denominator."""
    p, n, n_pad = 20, 500, 640
    xn, c, mask = _setup(p, n, seed=5)
    xp = np.zeros((p, n_pad), np.float32)
    xp[:, :n] = xn
    s_exact = _port(xn, c, mask)
    s_pad = _port(xp, c, mask, n_valid=torch.tensor(n))
    _close(s_pad, s_exact)
    s_k = j_kernel(jnp.asarray(xp), jnp.asarray(c), jnp.asarray(mask), block=8,
                   block_n=128, interpret=True, n_valid=jnp.asarray(n))
    _close(s_pad, s_k)


def test_wrapper_checks_inputs():
    xn, c, mask = (torch.from_numpy(a) for a in _setup(9, 64, seed=1))
    with pytest.raises(TypeError):
        fs.fused_score_vector(xn.double(), c, mask)
    with pytest.raises(TypeError):
        fs.fused_score_vector(xn, c, mask.float())
    with pytest.raises(ValueError):
        fs.fused_score_vector(xn, c[:8, :8], mask)
    with pytest.raises(ValueError):
        fs.fused_score_vector(xn.T.contiguous().T, c, mask)
    with pytest.raises(ValueError):
        fs.fused_score_vector(xn, c, mask, block=33)
    with pytest.raises(ValueError):
        fs.fused_score_vector(xn.to("meta"), c.to("meta"), mask.to("meta"))


def test_cpu_route_runs_plain_version_uncounted():
    xn, c, mask = (torch.from_numpy(a) for a in _setup(12, 200, seed=2))
    before = fs.LAUNCHES
    s = ops.score_vector(xn, c, mask)
    assert fs.LAUNCHES == before
    assert torch.equal(s, fs.fused_score_vector_ref(xn, c, mask))


@pytest.mark.parametrize("b,tiles", [(8, 1), (8, 120), (8, 2016), (16, 6), (32, 3),
                                     (7, 10), (2, 1)])
def test_lanes_fit_one_thread_block(b, tiles):
    """The tile kernel's launch: b * b * lanes threads, at least 2 b (the
    partial writers) and at most 1024, and its dynamic shared memory (two
    staging buffers or the lane reduction) inside one H100 block's."""
    lanes = fs._lanes(b, tiles)
    threads = b * b * lanes
    assert 2 * b <= threads <= 1024
    smem = fs._smem_bytes(b, lanes)
    assert 4 * 2 * 2 * b * fs.STAGE_LD <= smem <= 227 * 1024
    assert smem >= 4 * (4 * threads + 2 * b * b)
    assert fs.STAGE_LD % 4 == 0 and fs.STAGE_LD % 32 == 4  # 16-byte rows, distinct banks


def _ragged_bucket(shapes, n_pad, seed):
    """Ragged normalized datasets zero-padded into one bucket (JAX side), with
    dead rows holding NaN in xn and c and one valid count per dataset."""
    rng = np.random.default_rng(seed)
    p_pad = max(p for p, _ in shapes)
    xs = np.zeros((len(shapes), p_pad, n_pad), np.float32)
    cs = np.full((len(shapes), p_pad, p_pad), np.nan, np.float32)
    mask = np.zeros((len(shapes), p_pad), bool)
    for i, (p, n) in enumerate(shapes):
        xn = np.array(jax.jit(normalize)(jnp.asarray(rng.standard_normal((p, n)), jnp.float32)))
        xs[i, :p, :n] = xn
        xs[i, p:] = np.nan
        cs[i, :p, :p] = np.array(jax.jit(cov_matrix)(jnp.asarray(xn)))
        mask[i, :p] = True
    return xs, cs, mask, np.array([n for _, n in shapes], np.int32)


def test_batch_plain_matches_pallas_batch_kernel():
    """Ragged p and n in one bucket, NaN dead rows, per-dataset valid counts;
    each dataset's scores within SCORE_SHARE of its largest score."""
    xs, cs, mask, nv = _ragged_bucket([(20, 600), (13, 450), (17, 512)], 640, 21)
    s_t = fs.fused_score_batch(torch.from_numpy(xs), torch.from_numpy(cs),
                               torch.from_numpy(mask), n_valid=torch.from_numpy(nv)).numpy()
    s_k = j_batch_kernel(jnp.asarray(xs), jnp.asarray(cs), jnp.asarray(mask), block=8,
                         block_n=128, interpret=True, n_valid=jnp.asarray(nv))
    for i in range(xs.shape[0]):
        assert np.all(np.isinf(s_t[i][~mask[i]]))
        _close(s_t[i], np.asarray(s_k[i]), mask[i])


def test_batch_plain_is_vector_plain_row_for_row():
    xs, cs, mask, nv = _ragged_bucket([(9, 300), (16, 280), (12, 320)], 320, 4)
    xs_t, cs_t, mask_t = (torch.from_numpy(a) for a in (xs, cs, mask))
    nv_t = torch.from_numpy(nv)
    s = fs.fused_score_batch_ref(xs_t, cs_t, mask_t, n_valid=nv_t)
    for i in range(xs.shape[0]):
        assert torch.equal(s[i], fs.fused_score_vector_ref(xs_t[i], cs_t[i], mask_t[i],
                                                           n_valid=nv_t[i]))


def test_batch_prologue_equals_per_dataset_prologue():
    """What the card's wrapper prepares for a bucket (the (B,) int32 valid
    counts, the live tiles, the chunk counts) is, dataset by dataset, what
    it prepares for each dataset alone: nothing of it depends on B."""
    xs, cs, mask, nv = _ragged_bucket([(21, 600), (10, 500), (16, 640)], 640, 9)
    mask_t, nv_t = torch.from_numpy(mask), torch.from_numpy(nv).long()
    counts = fs._valid_counts(nv_t, 3, "cpu")
    assert counts.dtype == torch.int32 and counts.tolist() == nv.tolist()
    live = measure.live_tiles(mask_t, 8)
    swept, padded = measure.sweep_chunks(mask_t, nv_t, 640, 8)
    one_swept = one_padded = 0
    for i in range(3):
        assert torch.equal(fs._valid_counts(nv_t[i], 1, "cpu"), counts[i:i + 1])
        assert torch.equal(measure.live_tiles(mask_t[i:i + 1], 8), live[i:i + 1])
        s_i, p_i = measure.sweep_chunks(mask_t[i:i + 1], nv_t[i:i + 1], 640, 8)
        one_swept, one_padded = one_swept + s_i, one_padded + p_i
    assert (swept, padded) == (one_swept, one_padded)
    assert fs._valid_counts(None, 3, "cpu") is None
    assert fs._valid_counts(700, 2, "cpu").tolist() == [700, 700]


@pytest.mark.parametrize("nt", [1, 2, 5, 16])
def test_tile_maps_cover_every_block_pair_once(nt):
    """The sweep's grid: every pair of row blocks i <= j exactly once, the
    diagonal tiles included, row by row (row block i's diagonal tile, then
    its tiles with j > i)."""
    i, j = fs.tile_maps(nt).long()
    assert i.numel() == nt * (nt + 1) // 2 and bool(torch.all(i <= j))
    pairs = list(zip(i.tolist(), j.tolist()))
    assert pairs == sorted(set(pairs)) == [(a, b) for a in range(nt) for b in range(a, nt)]


def test_live_tile_rule():
    """A tile holds a live pair iff each of its blocks has a live row, and
    a diagonal tile iff its block has two; rows past p never count."""
    mask = torch.zeros((4, 19), dtype=torch.bool)  # blocks of 8: rows 0-7, 8-15, 16-18
    mask[1, 3] = True  # one live row: no pair anywhere
    mask[2, [3, 17]] = True  # one row in blocks 0 and 2: only tile (0, 2)
    mask[3, [9, 12]] = True  # two rows in block 1: only its diagonal tile
    live = measure.live_tiles(mask, 8)
    i, j = fs.tile_maps(3).long()
    tiles = [list(zip(i[row].tolist(), j[row].tolist())) for row in live]
    assert tiles == [[], [], [(0, 2)], [(1, 1)]]


@pytest.mark.parametrize("nv,n", [(700, 1024), (512, 16384), (8193, 16384), (1, 64),
                                  (4096, 2048)])
def test_sweep_stops_at_each_datasets_valid_count(nv, n):
    """Each live tile stages ceil(min(n_valid, n) / BLOCK_N) chunks of its
    own dataset, against ceil(n / BLOCK_N) for every tile of a padded sweep."""
    mask = torch.zeros((2, 20), dtype=torch.bool)
    mask[0, :20] = True  # all 6 tiles live
    mask[1, [0, 1, 9]] = True  # tiles (0, 0) and (0, 1)
    counts = torch.tensor([nv, n // 2])
    swept, padded = measure.sweep_chunks(mask, counts, n, 8)
    per = [-(-min(v, n) // fs.BLOCK_N) for v in counts.tolist()]
    assert swept == 6 * per[0] + 2 * per[1]
    assert padded == 12 * -(-n // fs.BLOCK_N)


def _schedule_scores(xn, c, mask, b=8, n_valid=None):
    """The kernel's schedule as torch ops: per tile of ``tile_maps`` its
    partial scores (zero for a tile ``live_tiles`` skips), written to slot
    (i, j) and, off the diagonal, (j, i) of an (nt, nt, b) buffer, then each
    row's diagonal partial plus its other partials in ascending block order.
    The diagonal tile takes both directions from one (a, q) element, the
    reverse with c_qa, and credits only the row sum."""
    from repro_torch.core.pairwise import residual_entropy_block_pair, row_entropies

    p, n = xn.shape
    nt = -(-p // b)
    pad = nt * b - p
    x = torch.cat([torch.where(mask[:, None], xn, 0.0), xn.new_zeros(pad, n)]).reshape(nt, b, n)
    cp = torch.nn.functional.pad(torch.where(mask[:, None] & mask[None, :], c, 0.0),
                                 (0, pad, 0, pad))
    mb = torch.cat([mask, mask.new_zeros(pad)]).reshape(nt, b)
    hx = torch.nn.functional.pad(row_entropies(xn, mask, n_valid=n_valid), (0, pad)).reshape(nt, b)
    slots = torch.full((nt, nt, b), torch.nan)
    live = measure.live_tiles(mask[None], b)[0]
    eye = torch.eye(b, dtype=torch.bool)
    for t, (i, j) in enumerate(zip(*fs.tile_maps(nt).tolist())):
        if not live[t]:
            slots[i, j] = slots[j, i] = 0.0
            continue
        c_ij = cp[i * b:(i + 1) * b, j * b:(j + 1) * b]
        hr_f, hr_r = residual_entropy_block_pair(x[i], c_ij, x[j], n_valid=n_valid)
        if i == j:  # the reverse residual of (a, q) regresses with c_qa
            hr_r = residual_entropy_block_pair(x[i], c_ij.T, x[i], n_valid=n_valid)[0].T
        stat = (hx[j][None, :] - hx[i][:, None]) + (hr_f - hr_r)
        pm = mb[i][:, None] & mb[j][None, :] & ~(eye if i == j else torch.zeros_like(eye))
        slots[i, j] = torch.where(pm, torch.clamp(stat, max=0.0) ** 2, 0.0).sum(dim=1)
        if i != j:
            slots[j, i] = torch.where(pm, torch.clamp(-stat, max=0.0) ** 2, 0.0).sum(dim=0)
    assert not torch.isnan(slots).any(), "a slot was never written"
    out = torch.empty(nt, b)
    for r in range(nt):
        acc = torch.zeros(b)
        for m in range(nt):
            if m != r:
                acc = acc + slots[r, m]
        out[r] = slots[r, r] + acc
    return torch.where(mask, out.reshape(-1)[:p], torch.inf)


@pytest.mark.parametrize("dead", ["none", "scattered", "blocks"])
def test_kernel_schedule_matches_plain_and_pallas(dead):
    """The tile maps, the live-tile rule and the reduce order, run as torch
    ops, give the plain version's scores and the Pallas kernel's (interpret
    mode): every pair is credited once, skipped tiles hold no live pair."""
    p, n = 29, 700
    xn, c, mask = _setup(p, n, seed=17)
    if dead == "scattered":
        mask[[2, 11, 12, 20]] = False
    elif dead == "blocks":
        mask[8:16] = False
        mask[17:] = False
    xn[~mask] = np.nan
    c[~mask] = np.nan
    c[:, ~mask] = np.nan
    s_sched = _schedule_scores(*(torch.from_numpy(a) for a in (xn, c, mask)))
    _close(s_sched.numpy(), _port(xn, c, mask), mask)
    s_k = j_kernel(jnp.asarray(xn), jnp.asarray(c), jnp.asarray(mask), block=8, interpret=True)
    _close(s_sched.numpy(), s_k, mask)
    assert np.all(np.isinf(s_sched.numpy()[~mask]))


def _log1p_unit_coefficients():
    """The polynomial's coefficients as the CUDA sources state them (the
    header both score kernels include), from the highest degree down."""
    import pathlib
    import re

    src = (pathlib.Path(fs.__file__).parent / "csrc" / "lingam_math.cuh").read_text()
    body = src[src.index("float log1p_unit(float e) {"):]
    body = body[:body.index("return e * r;")]
    first = re.search(r"fmaf\(([-0-9.e]+)f, e, ([-0-9.e]+)f\)", body)
    rest = re.findall(r"fmaf\(r, e, ([-0-9.e]+)f\)", body)
    return [np.float32(first.group(1)), np.float32(first.group(2))] + [np.float32(v) for v in rest]


def test_log1p_unit_within_two_ulp():
    """The kernel's log1p(e), e = exp(-2|u|), emulated in float32 with fused
    multiply-adds (exact float64 product, one rounding of the sum) on 2e6+1
    points u in [-60, 60], is within 2 ulp of float64 log1p (1.39 measured),
    and rounds to float32 log 2 at e = 1, so that log cosh 0 = (0 + log 2)
    - log 2 is exactly 0 with no select in the kernel."""
    coef = _log1p_unit_coefficients()
    assert len(coef) == 11 and coef[-1] == 1.0
    u = np.linspace(-60, 60, 2_000_001).astype(np.float32)
    e = np.exp(np.float32(-2) * np.abs(u), dtype=np.float32)
    r = np.full_like(e, coef[0])
    for v in coef[1:]:
        r = (r.astype(np.float64) * e + np.float64(v)).astype(np.float32)
    got = (e * r).astype(np.float64)
    want = np.log1p(e.astype(np.float64))
    spacing = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
    assert np.max(np.abs(got - want) / spacing) <= 2.0
    assert got[np.abs(u) == 0][0] == np.float64(np.float32(np.log(2.0)))


def test_sass_loop_counts():
    """The SASS parser behind the kernels' instruction bound: the innermost
    backward branch (label or address target) closes the sample loop, its
    counts are scaled to one element by its MUFU.EX2, predicates and NOPs
    aside; only FP32 arithmetic counts as FP32 (not loads, integer address
    arithmetic, moves or the branch)."""
    sass = """
        Function : _ZN12_GLOBAL__N_115fused_tri_tilesEPKf
        /*0000*/                   MOV R1, c[0x0][0x28] ;
.L_x_1:
        /*0010*/                   LDS R2, [R3] ;
.L_x_2:
        /*0020*/                   MUFU.EX2 R4, R2 ;
        /*0030*/                   FFMA R4, R2, R2, R4 ;
        /*0040*/                   NOP ;
        /*0050*/                   IMAD R6, R6, 0x4, R7 ;
        /*0060*/                   FADD.FTZ R5, R4, R2 ;
        /*0070*/                   MUFU.EX2 R5, R2 ;
        /*0080*/               @P0 BRA `(.L_x_2) ;
        /*0090*/              @!P1 BRA 0x10 ;
        /*00a0*/                   EXIT ;
        Function : _ZN12_GLOBAL__N_113row_entropiesEPKf
        /*0000*/                   MUFU.EX2 R4, R2 ;
        /*0010*/                   BRA 0x0 ;
    """
    got = measure.sample_loop(sass, "fused_tri_tiles", 1)
    assert (got.loop.start, got.loop.end) == (0x20, 0x80)
    assert got.loop.ops == ("MUFU.EX2", "FFMA", "IMAD", "FADD.FTZ", "MUFU.EX2", "BRA")
    assert (got.instructions, got.fp32, got.mufu) == (3.0, 1.0, 1.0)
    rows = measure.sample_loop(sass, "row_entropies", 1)
    assert (rows.instructions, rows.fp32, rows.mufu) == (2.0, 0.0, 1.0)
    with pytest.raises(ValueError):
        measure.sample_loop(sass, "fused_tri_tiles", 4)


def test_batch_wrapper_checks_inputs():
    xs, cs, mask, _ = (torch.from_numpy(a) for a in _ragged_bucket([(9, 64), (9, 64)], 64, 1))
    with pytest.raises(ValueError, match="B, p, n"):
        fs.fused_score_batch(xs[0], cs[0], mask[0])
    with pytest.raises(ValueError):
        fs.fused_score_batch(xs, cs[:, :8, :8], mask)
    with pytest.raises(ValueError):
        fs.fused_score_batch(xs, cs, mask[:1])
    with pytest.raises(TypeError):
        fs.fused_score_batch(xs.double(), cs, mask)
    with pytest.raises(ValueError):
        fs.fused_score_batch(xs.to("meta"), cs.to("meta"), mask.to("meta"))


def test_batch_cpu_route_runs_plain_version_uncounted():
    xs, cs, mask, nv = (torch.from_numpy(a) for a in _ragged_bucket([(12, 200), (7, 150)], 200, 2))
    before = fs.BATCH_LAUNCHES
    s = ops.score_batch(xs, cs, mask, n_valid=nv)
    assert fs.BATCH_LAUNCHES == before
    assert torch.equal(s, fs.fused_score_batch_ref(xs, cs, mask, n_valid=nv))
