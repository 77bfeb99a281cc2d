"""Rank-1 iteration updates (paper Algorithms 7 and 8): the CUDA kernel's
wrappers and their plain versions.

One kernel, ``csrc/covupdate.cu``, in three modes of one design.

TPU-kernel mode replaces the TPU kernels ``_update_data_kernel``
(``src/repro/kernels/covupdate.py:21``, called at ``:56``) and
``_update_cov_kernel`` (``:29``, called at ``:86``) through
:func:`update_data` and :func:`update_cov`, for one dataset of any p and n
(no padding copies):

    update_data: (x - b x_root) * rsqrt(max(1 - b^2, 1e-12)), row by row
    update_cov:  (c - b b^T) * inv inv^T, the unit diagonal restored

``b`` is the regression coefficient of every row on the root (``c[:,
root]``) with the root's own entry, and any dead row's, zeroed by the
caller: no clip, no floor but 1e-12, no renormalization.

Fit mode, :func:`rank1_update`, is the update the scan runs on every
iteration: ``core.covariance.update_data`` then ``update_cov`` (the JAX
package's ``src/repro/core/covariance.py:87-141``: b gathered from ``c[:,
root]`` and gated by ``rank1_gates``, the drift renormalization of the live
rows, the clipped correlations), over a bucket ``(B, m, n)`` with one root,
live-row mask and valid count per dataset, in one launch for the whole
bucket. ``fit``, ``fit_batch``, the engines, the threshold fits,
``causal_order_scan`` and the host driver take it under the ``hopper`` and
``hopper_fused`` backends; ``torch`` and ``torch_fused`` keep the plain
updates, the reference the kernel is held to. Its plain version is that
composition itself.

Ring mode, :func:`ring_update`, is that update on one rank's row block of
the messaging ring (``dist.ring_order._update_shard``): the rows
``[row0, row0 + m_l)`` of x (this rank's sample shard) and of c, with the
root's data row and the gates of the own rows and of every column given by
the caller (they come from other ranks). One launch where the samples are
whole; where they are sharded, a first launch writes each row's sum of
squares and c', the caller's ``reduce`` sums them across the sample shards,
and a second launch scales the rows. Its plain version,
:func:`ring_update_ref`, is the ring's torch update itself, and the kernel
is bit-equal to it (the sums in torch.sum's order over the (m_l, n_loc)
squares). The ring takes it under the ``hopper`` backends on the card.

What bounds every mode: memory (each element read and written once, ~6 FP32
operations), and at these sizes the launch and one row's latency: an empty
kernel on the same grid is measured beside each time (``chip_smoke.py``).
Fit and ring modes take each data row on one of three paths
(:func:`update_plan` mirrors the kernel's host plan; :func:`kernel_plan`
reads the kernel's own): a row torch sums over 16 warps spread over a
thread-block cluster of 1, 2 or 4 CTAs, each staging (bulk copies) and
replaying its share of torch's threads, the warp partials exchanged
through distributed shared memory; several rows per block where torch
gives a row one warp; one CTA per row otherwise (unaligned, few or very
long rows). ``launch_rank1`` and ``launch_ring`` take ``cluster`` and
``rows`` to force a plan (the tests hold every plan to the plain version;
the entry points never force one). The correlation
update is written to a second buffer (every block reads column ``root`` of
c); x' may overwrite x (``inplace=True``) where the caller owns x, which
the scan does after its first update: its first stage's buffers are the
caller's tensors. Every rounding step follows the plain version's, the
variance's float32 sum of squares included: the kernel replays the order in
which torch.sum reduces the (B * m, n) squares on the card (ATen's reduce
kernel: its block shape, vectors, accumulators and trees; see the source),
so x' and c' are bit-equal to the plain version (``SCALE_ULP_TOL`` = 0;
``sum_probe`` holds the order against torch.sum itself).

On a CPU tensor the wrappers run the plain version; on a CUDA tensor they
launch the kernel or raise; on a fake CUDA tensor (the dry run's) they
allocate what the launch writes (x' over ``xb`` in place) and note its
``flops`` (``kernels/_fake.py``).
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from repro_torch.core import covariance
from repro_torch.kernels import _fake

#: Kernel launches since the last reset, one per call on the card.
DATA_LAUNCHES = 0
COV_LAUNCHES = 0
RANK1_LAUNCHES = 0
RING_LAUNCHES = 0
_count_mu = threading.Lock()

#: Fit mode on the card against its plain version: a live row's
#: renormalization scale within this many float32 ulp. The kernel sums the
#: squares in torch.sum's order, so the scales are the same bits.
SCALE_ULP_TOL = 0

#: Grid modes of the kernel (``blocks``, ``launch_empty``); ``MODE_RING``'s
#: grid is its first launch's, with ``batch`` the block's rows m_l.
MODE_DATA, MODE_COV, MODE_FIT, MODE_RING = 0, 1, 2, 3
#: Ring mode's launches: sums and scale in one, the sums (and c'), the scale.
RING_FUSED, RING_SUMS, RING_SCALE = 0, 1, 2

#: FP32 operations per element updated (x or c), as the bound counts them.
FP32_PER_ELEMENT = 6

#: (rows, n) of torch.sum over the squares: the fit mode's shapes (the E.
#: coli dispatch's stages, the E. coli and p=512 fits), the ring's blocks
#: at (1, 2, 2), and one of each other shape ATen takes (unaligned rows,
#: fewer than 16 rows, scalar loads, a row split across blocks).
SUM_ORDER_SHAPES = ((1024, 16384), (512, 16384), (256, 16384), (128, 10_000), (512, 2000),
                    (64, 5000), (74, 1301), (8, 3000), (3, 100), (2, 300_000), (40, 131_072))

#: The data rows' paths of fit and ring modes (see ``update_plan``).
PATH_CLUSTER, PATH_WARPS, PATH_ROW = 0, 1, 2
#: The H100's SMs and threads per SM (ATen's block count of very long rows
#: reads them), and the shared memory one block may use, in bytes.
H100_SMS, THREADS_PER_SM, SMEM_MAX = 132, 2048, 232_448
#: A cluster CTA's staging that leaves room for three CTAs per SM.
SMEM_SHARE = 72 * 1024
# The kernel's own constants (csrc/covupdate.cu), which its plan reads.
_TORCH_THREADS, _MAX_CTAS, _MAX_ROWS = 512, 2048, 8
_BAR_BYTES, _RED_SMALL = 16, 40
_COL_CHUNK, _TILE_ELEMS, _TILE_ROWS = 2048, 2048, 64


def flops(x_elems: int, c_elems: int) -> float:
    """The FP32 operations of one launch that updates ``x_elems`` elements
    of the rows and ``c_elems`` of the correlations, every row live."""
    return float(FP32_PER_ELEMENT * (x_elems + c_elems))


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _last_pow2(v: int) -> int:
    return 1 << (max(v, 1).bit_length() - 1)


def torch_sum_order(rows: int, n: int, sms: int = H100_SMS,
                    threads_per_sm: int = THREADS_PER_SM) -> dict:
    """How torch.sum reduces a contiguous (rows, n) float32 tensor over its
    last dimension on the card (ATen's ``setReduceConfig``, as the kernel's
    ``torch_sum_of`` replays it): a block of ``bw`` x ``bh`` threads, its
    warps sharing one row where ``split``, ``ctas`` blocks per row, 16-byte
    ``vec``tors, and the ``threads`` that sum one row in one block."""
    vec = n >= 128
    dim0 = n // 4 if vec else n
    dim0_pow2 = _last_pow2(dim0) if dim0 < _TORCH_THREADS else _TORCH_THREADS
    dim1_pow2 = _last_pow2(rows) if rows < _TORCH_THREADS else _TORCH_THREADS
    bw = min(dim0_pow2, 32)
    bh = min(dim1_pow2, _TORCH_THREADS // bw)
    bw = min(dim0_pow2, _TORCH_THREADS // bh)
    split = _ceil_div(n, bw) >= min(bh * 16, 256)
    ctas = 1
    per_thread = _ceil_div(n, bw * bh)
    if split and per_thread >= 256:
        target = sms * (threads_per_sm // (bw * bh))
        if rows <= target:
            ctas = max(min(_ceil_div(target, rows), _ceil_div(per_thread, 16)),
                       _ceil_div(per_thread, 256))
    return {"vec": vec, "bw": bw, "bh": bh, "split": split, "ctas": ctas,
            "threads": bw * bh if split else bw}


def _smem(red: int, cap: int, rows: int) -> int:
    return _BAR_BYTES + 4 * red + 4 * cap * rows


def update_plan(kind: int, batch: int, m: int, n: int, *, vec: bool | None = None,
                cluster: int = 0, rows: int = 0, sms: int = H100_SMS, cov: bool = True) -> dict:
    """The kernel's plan of a fit-mode (``kind`` ``MODE_FIT``: ``batch``
    datasets of m rows) or ring-mode launch (``MODE_RING``: ``batch`` is the
    block's rows m_l, of an (m_l, m) correlation block), as its host code
    (``plan_rows``, ``launch_plan``) makes it: torch's order (``order``,
    :func:`torch_sum_order`); the data rows' ``path`` (``PATH_CLUSTER``: a
    row over a cluster of ``k`` CTAs; ``PATH_WARPS``: ``rows`` rows per
    block, a warp each; ``PATH_ROW``: a CTA per row, ``staged`` whole when
    it fits); ``cap`` floats staged per row and CTA, ``data_blocks``,
    ``blocks`` and ``smem`` bytes; and ``shares``: for each CTA of one row,
    the torch threads it replays (``threads``, a half-open range; for the
    row path every thread of every torch block, ``threads * ctas``) and the
    runs of columns it stages and stores (``runs``). ``vec``: 16-byte rows
    (default: n a multiple of 4); ``cluster``, ``rows``: forced (0: chosen),
    ValueError where the shape cannot take them; ``cov`` False for ring
    mode's scale launch (no tiles)."""
    if kind not in (MODE_FIT, MODE_RING) or min(batch, m, n) < 1:
        raise ValueError(f"update_plan takes MODE_FIT or MODE_RING and positive sizes, got "
                         f"{kind}, {batch}, {m}, {n}")
    vec = n % 4 == 0 if vec is None else vec
    sets, per = (1, batch) if kind == MODE_RING else (batch, m)
    o = torch_sum_order(sets * per, n, sms)
    if o["ctas"] > _MAX_CTAS:
        raise ValueError(f"torch sums a row of {n} in {o['ctas']} blocks: refused")
    total, nvec = sets * per, n // 4
    fast = vec and o["vec"] and o["bw"] == 32 and o["ctas"] == 1
    plan = None
    if fast and o["split"]:
        t, pick = o["threads"], 0
        for k in (4, 2, 1):
            cap = 4 * _ceil_div(nvec, t) * (t // k)
            smem = _smem(_RED_SMALL, cap, 1)
            if o["bh"] % k or smem > SMEM_MAX:
                continue
            if cluster:
                pick = k if k == cluster else pick
            elif not pick or (k * total >= 4 * sms and smem <= SMEM_SHARE):
                pick = k
        if pick:
            if rows > 1:
                raise ValueError("the cluster path takes one row per block")
            cap = 4 * _ceil_div(nvec, t) * (t // pick)
            plan = dict(path=PATH_CLUSTER, k=pick, rows=1, groups=1, cap=cap, staged=True,
                        smem=_smem(_RED_SMALL, cap, 1), data_blocks=total * pick)
    elif fast:
        pick = 0
        r = 1
        while r <= _MAX_ROWS and _smem(_RED_SMALL, n, r) <= SMEM_MAX:
            if (r == rows) if rows else (r == 1 or sets * _ceil_div(per, r) >= sms):
                pick = r
            r *= 2
        if pick:
            if cluster > 1:
                raise ValueError("the warp path takes no cluster")
            groups = _ceil_div(per, pick)
            plan = dict(path=PATH_WARPS, k=1, rows=pick, groups=groups, cap=n, staged=True,
                        smem=_smem(_RED_SMALL, n, pick), data_blocks=sets * groups)
    if plan is None:
        if cluster > 1 or rows > 1:
            raise ValueError(f"a forced cluster of {cluster} or {rows} rows per block does not "
                             f"fit rows of {n} columns")
        red = 4 * _ceil_div(_TORCH_THREADS + o["ctas"], 4)
        cap = 4 * _ceil_div(n, 4)
        staged = _smem(red, cap, 1) <= SMEM_MAX
        cap = cap if staged else 0
        plan = dict(path=PATH_ROW, k=1, rows=1, groups=1, cap=cap, staged=staged,
                    smem=_smem(red, cap, 1), data_blocks=total)
    # the correlation tiles (plan_of): tiles of <= 2,048 entries of the rows
    cov_blocks, tiles_smem = 0, 0
    if cov:
        w = min(m, _COL_CHUNK)
        tile_rows = min(max(_TILE_ELEMS // w, 1), _TILE_ROWS)
        cov_blocks = sets * _ceil_div(per, tile_rows) * _ceil_div(m, _COL_CHUNK)
        tiles_smem = (w + _TILE_ROWS) * 8
    k = plan["k"]
    plan["blocks"] = k * _ceil_div(plan["data_blocks"] + cov_blocks, k)
    plan["smem"] = max(plan["smem"], tiles_smem)
    if plan["path"] == PATH_CLUSTER:
        t, share = o["threads"], o["threads"] // k
        plan["shares"] = [{"threads": (r * share, (r + 1) * share),
                         "runs": [(4 * v, 4 * min(v + share, nvec))
                                  for v in range(r * share, nvec, t)]} for r in range(k)]
    else:
        plan["shares"] = [{"threads": (0, o["threads"] * o["ctas"]), "runs": [(0, n)]}]
    plan["order"] = o
    return plan


def aten_reads(n: int, shift: int, order: dict, nv: int | None = None) -> dict:
    """The columns each thread of torch.sum's reduce reads of one row of n
    (``torch_thread_sum`` of the kernel): ``{(u, c): [column, ...]}`` for
    thread u of torch's block c, in the order it adds them, the head and
    tail elements included (``shift``: the row's offset in floats past a
    16-byte boundary; ``nv``: columns read at most, default n)."""
    nv = n if nv is None else nv
    stride = order["threads"] * order["ctas"]
    reads = {}
    for c in range(order["ctas"]):
        for u in range(order["threads"]):
            cols = []
            idx0 = u + c * order["threads"]
            edge = c == 0 and u < 4
            if order["vec"]:
                e0 = (4 - shift) & 3
                ln = n - e0
                if edge and shift > 0 and u >= shift:
                    cols.append(u - shift)
                v = idx0
                while 4 * v + 3 < ln and e0 + 4 * v < nv:
                    cols.extend(e0 + 4 * v + i for i in range(4))
                    v += stride
                if edge and u < ln % 4:
                    cols.append(e0 + ln - ln % 4 + u)
            else:
                cols.extend(range(idx0, min(n, nv), stride))
            reads[(u, c)] = cols
    return reads


def _inv_scale(b):
    """1 / sqrt(max(1 - b^2, 1e-12)), as the kernels round it."""
    return 1.0 / torch.sqrt(torch.clamp(1.0 - b * b, min=covariance.VAR_EPS))


def update_data_ref(x, x_root, b):
    """Plain version of :func:`update_data`, in the TPU kernel's order of
    operations: ``(x - b x_root) * inv``."""
    return (x - b[:, None] * x_root[None, :]) * _inv_scale(b)[:, None]


def update_cov_ref(c, b):
    """Plain version of :func:`update_cov`: ``(c - b b^T) * inv_i * inv_j``,
    then exactly 1 on the diagonal."""
    inv = _inv_scale(b)
    new = (c - b[:, None] * b[None, :]) * inv[:, None] * inv[None, :]
    eye = torch.eye(c.shape[0], dtype=torch.bool, device=c.device)
    return torch.where(eye, 1.0, new)


def ring_bytes(live_rows: int, m_l: int, m: int, n_loc: int) -> int:
    """The bytes a ring-mode update must move, whatever its launches: each
    live row of x read and written once, the root's row, the (m_l, m)
    correlation block read and written, the gates, the live mask and the
    sums."""
    return 8 * live_rows * n_loc + 4 * n_loc + 8 * m_l * m + 4 * (3 * m_l + 2 * m) + m_l


def ring_update_ref(x_loc, c_loc, x_root, b, s_row, b_col, s_col, live, *, row0: int,
                    n: int, reduce=None):
    """Plain version of :func:`ring_update`: the ring's update of its own
    rows in torch ops, ``(x_loc', c_loc')``."""
    out = (x_loc - b[:, None] * x_root[None, :]) / s_row[:, None]
    sq = torch.sum(torch.square(out), dim=-1)
    if reduce is not None:
        reduce(sq)
    scale = torch.where(live, torch.rsqrt(torch.clamp(sq / max(n - 1, 1), min=covariance.VAR_EPS)),
                        1.0)
    m_l, m = c_loc.shape
    dev = c_loc.device
    row_ids = row0 + torch.arange(m_l, device=dev)
    cols = torch.arange(m, device=dev)
    c2 = (c_loc - b[:, None] * b_col[None, :]) / (s_row[:, None] * s_col[None, :])
    c2 = torch.where(row_ids[:, None] == cols[None, :], 1.0, torch.clamp(c2, -1.0, 1.0))
    return out * scale[:, None], c2


def rank1_update_ref(xb, cb, roots, mloc, n_valid=None):
    """Plain version of :func:`rank1_update`: the scan's own composition,
    ``covariance.update_data`` then ``covariance.update_cov``."""
    return (covariance.update_data(xb, cb, roots, mloc, n_valid=n_valid),
            covariance.update_cov(cb, roots, mloc))


def _check(name, *tensors):
    dev = tensors[0].device
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} takes float32 tensors, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors")
        if t.numel() < 1:
            raise ValueError(f"{name}: empty tensor {tuple(t.shape)}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")


@functools.cache
def _entries():
    from repro_torch.kernels import _build

    lib = _build.load("covupdate")
    ptr, num = ctypes.c_void_p, ctypes.c_int
    sigs = {"update_data_launch": [ptr] * 4 + [num] * 2 + [ptr],
            "update_cov_launch": [ptr] * 3 + [num, ptr],
            "rank1_update_launch": [ptr] * 7 + [num] * 5 + [ptr],
            "rank1_update_blocks": [num] * 4,
            "rank1_update_empty_launch": [num] * 4 + [ptr],
            "rank1_update_plan": [num] * 7 + [ctypes.POINTER(num)],
            "ring_update_launch": [ptr] * 11 + [num] * 8 + [ptr],
            "rank1_scale_probe": [ptr, ptr, num, ptr],
            "rank1_sum_probe": [ptr, ptr, num, num, ctypes.POINTER(num), ptr]}
    fns = {}
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[name] = fn
    return fns


def _raise_on(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def launch_data(x, x_root, b):
    """The update_data kernel on checked CUDA tensors. Counts nothing."""
    p, n = x.shape
    out = torch.empty_like(x)
    _raise_on(_entries()["update_data_launch"](x.data_ptr(), x_root.data_ptr(), b.data_ptr(),
                                               out.data_ptr(), p, n, _stream(x)),
              "update_data")
    return out


def launch_cov(c, b):
    """The update_cov kernel on checked CUDA tensors. Counts nothing."""
    out = torch.empty_like(c)
    _raise_on(_entries()["update_cov_launch"](c.data_ptr(), b.data_ptr(), out.data_ptr(),
                                              c.shape[0], _stream(c)),
              "update_cov")
    return out


def _rank1_outputs(xb, cb, inplace: bool):
    """What a fit-mode launch writes: x' (``xb`` itself with ``inplace``)
    and a new c'."""
    return (xb if inplace else torch.empty_like(xb)), torch.empty_like(cb)


def launch_rank1(xb, cb, roots, mloc, n_valid=None, inplace=False, *, cluster=0, rows=0):
    """The fit-mode kernel on checked CUDA tensors (``roots`` int64,
    ``mloc`` bool, ``n_valid`` None or int32, all contiguous). Counts
    nothing. With ``inplace`` x' is written over ``xb``. ``cluster`` and
    ``rows`` force the plan's cluster size and rows per block (0: its own;
    see :func:`update_plan`)."""
    bsz, m, n = xb.shape
    x_out, c_out = _rank1_outputs(xb, cb, inplace)
    _raise_on(_entries()["rank1_update_launch"](
        xb.data_ptr(), x_out.data_ptr(), cb.data_ptr(), c_out.data_ptr(), roots.data_ptr(),
        mloc.data_ptr(), None if n_valid is None else n_valid.data_ptr(), bsz, m, n, cluster,
        rows, _stream(xb)), "rank1_update")
    return x_out, c_out


def launch_ring(x, x_out, c, c_out, x_root, b, s_row, b_col, s_col, live, sq, phase: int,
                row0: int, n: int, *, cluster=0, rows=0):
    """One ring-mode launch of ``phase`` on checked CUDA tensors (``live``
    bool, all contiguous; ``sq`` the (m_l,) sums). Counts nothing.
    ``cluster``, ``rows`` as in :func:`launch_rank1`."""
    m_l, n_loc = x.shape
    _raise_on(_entries()["ring_update_launch"](
        x.data_ptr(), x_out.data_ptr(), c.data_ptr(), c_out.data_ptr(), x_root.data_ptr(),
        b.data_ptr(), s_row.data_ptr(), b_col.data_ptr(), s_col.data_ptr(), live.data_ptr(),
        sq.data_ptr(), phase, m_l, c.shape[1], n_loc, row0, n, cluster, rows, _stream(x)),
        "ring_update")


#: The fields of ``rank1_update_plan``'s answer, in its order.
PLAN_FIELDS = ("bw", "bh", "split", "ctas", "vec", "threads", "path", "k", "rows", "staged",
               "cap", "data_blocks", "blocks", "smem")


def kernel_plan(kind: int, batch: int, m: int, n: int, *, vec: bool = True, cluster: int = 0,
                rows: int = 0) -> dict:
    """The plan the kernel's own host code makes for a launch (arguments as
    :func:`update_plan`'s, on the current card), by ``PLAN_FIELDS``: the
    card's check of :func:`update_plan`."""
    out = (ctypes.c_int * len(PLAN_FIELDS))()
    _raise_on(_entries()["rank1_update_plan"](kind, batch, m, n, int(vec), cluster, rows, out),
              "rank1_update_plan")
    return dict(zip(PLAN_FIELDS, out))


def blocks(mode: int, batch: int, m: int, n: int) -> int:
    """Blocks of 256 threads in a launch of ``mode`` (``MODE_DATA``:
    update_data of a (m, n) dataset, ``MODE_COV``: update_cov of a (m, m)
    one, ``MODE_FIT``: rank1_update of a (batch, m, n) bucket,
    ``MODE_RING``: ring_update's first launch on ``batch`` rows of an (n,
    m) block)."""
    return _entries()["rank1_update_blocks"](mode, batch, m, n)


def launch_empty(mode: int, batch: int, m: int, n: int, device):
    """An empty kernel on the grid of a ``mode`` launch: the launch floor."""
    _raise_on(_entries()["rank1_update_empty_launch"](
        mode, batch, m, n, torch.cuda.current_stream(device).cuda_stream), "rank1_update_empty")


def scale_probe(var):
    """The kernel's renormalization scale ``rsqrt(max(var, 1e-12))`` of
    every entry of a float32 CUDA tensor, computed on the card by the
    kernel's own device function (held against ``torch.rsqrt``)."""
    if var.dtype != torch.float32 or var.device.type != "cuda" or not var.is_contiguous():
        raise ValueError("scale_probe takes a contiguous float32 CUDA tensor")
    out = torch.empty_like(var)
    _raise_on(_entries()["rank1_scale_probe"](var.data_ptr(), out.data_ptr(), var.numel(),
                                              _stream(var)), "rank1_scale_probe")
    return out


def sum_probe(x):
    """``torch.sum(x * x, -1)`` of a contiguous float32 CUDA tensor ``(rows,
    n)`` in the order the fit mode replays torch's (its check against torch
    itself), and torch's block shape for it: ``(sums, (bw, bh, split, ctas,
    vectors))``."""
    if (x.dtype != torch.float32 or x.device.type != "cuda" or not x.is_contiguous()
            or x.ndim != 2):
        raise ValueError("sum_probe takes a contiguous float32 (rows, n) CUDA tensor")
    out = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    shape = (ctypes.c_int * 5)()
    _raise_on(_entries()["rank1_sum_probe"](x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1],
                                            shape, _stream(x)),
              "rank1_sum_probe")
    return out, tuple(shape)


def update_data(x, x_root, b):
    """Algorithm 7 on one dataset: ``x: (p, n)`` normalized rows, ``x_root:
    (n,)`` the root's row, ``b: (p,)`` with ``b[root] = 0``. Returns the
    (p, n) refreshed rows."""
    global DATA_LAUNCHES
    _check("update_data", x, x_root, b)
    p, n = x.shape if x.ndim == 2 else (0, 0)
    if x.ndim != 2 or tuple(x_root.shape) != (n,) or tuple(b.shape) != (p,):
        raise ValueError(f"want x (p, n), x_root (n,), b (p,); got {tuple(x.shape)}, "
                         f"{tuple(x_root.shape)}, {tuple(b.shape)}")
    if _fake.on_card(x):
        _fake.note("update_data", flops(x.numel(), 0))
        return torch.empty_like(x)
    if x.device.type == "cpu":
        return update_data_ref(x, x_root, b)
    out = launch_data(x, x_root, b)
    with _count_mu:
        DATA_LAUNCHES += 1
    return out


def update_cov(c, b):
    """Algorithm 8 on one dataset: ``c: (p, p)`` correlations, ``b: (p,)``
    with ``b[root] = 0``. Returns the (p, p) refreshed correlations, unit
    diagonal."""
    global COV_LAUNCHES
    _check("update_cov", c, b)
    p = c.shape[0]
    if c.ndim != 2 or tuple(c.shape) != (p, p) or tuple(b.shape) != (p,):
        raise ValueError(f"want c (p, p), b (p,); got {tuple(c.shape)}, {tuple(b.shape)}")
    if _fake.on_card(c):
        _fake.note("update_cov", flops(0, c.numel()))
        return torch.empty_like(c)
    if c.device.type == "cpu":
        return update_cov_ref(c, b)
    out = launch_cov(c, b)
    with _count_mu:
        COV_LAUNCHES += 1
    return out


def rank1_update(xb, cb, roots, mloc, n_valid=None, *, inplace=False):
    """One scan iteration's Algorithms 7 and 8 over a bucket: ``xb: (B, m,
    n)`` normalized rows, ``cb: (B, m, m)`` correlations, ``roots: (B,)``
    one root per dataset, ``mloc: (B, m)`` bool rows still in U (the root
    included), ``n_valid`` None or one valid sample count per dataset.
    Returns ``(xb', cb')`` as ``covariance.update_data`` and ``update_cov``
    give them. ``cb'`` is always a new tensor; with ``inplace`` x' is
    written over ``xb`` (which the caller then no longer needs) and ``xb``
    is returned."""
    global RANK1_LAUNCHES
    _check("rank1_update", xb, cb)
    bsz, m, n = xb.shape if xb.ndim == 3 else (0, 0, 0)
    if (xb.ndim != 3 or tuple(cb.shape) != (bsz, m, m) or tuple(roots.shape) != (bsz,)
            or tuple(mloc.shape) != (bsz, m)
            or (n_valid is not None and tuple(n_valid.shape) != (bsz,))):
        raise ValueError(
            f"want xb (B, m, n), cb (B, m, m), roots (B,), mloc (B, m), n_valid None or (B,); "
            f"got {tuple(xb.shape)}, {tuple(cb.shape)}, {tuple(roots.shape)}, "
            f"{tuple(mloc.shape)}, {None if n_valid is None else tuple(n_valid.shape)}")
    if roots.dtype.is_floating_point or (n_valid is not None and n_valid.dtype.is_floating_point):
        raise TypeError("rank1_update takes integer roots and valid counts")
    if mloc.dtype != torch.bool:
        raise TypeError(f"rank1_update takes a bool mask, got {mloc.dtype}")
    if any(t.device != xb.device for t in (roots, mloc) + (() if n_valid is None else (n_valid,))):
        raise ValueError("rank1_update: roots, mask and valid counts must lie on xb's device")
    if xb.device.type == "cpu" and not _fake.on_card(xb):
        x2, c2 = rank1_update_ref(xb, cb, roots, mloc, n_valid=n_valid)
        return (xb.copy_(x2) if inplace else x2), c2
    nv = None if n_valid is None else n_valid.to(torch.int32).contiguous()
    roots, mloc = roots.to(torch.int64).contiguous(), mloc.contiguous()
    if _fake.on_card(xb):
        _fake.note("rank1_update", flops(xb.numel(), cb.numel()))
        return _rank1_outputs(xb, cb, inplace)
    out = launch_rank1(xb, cb, roots, mloc, nv, inplace)
    with _count_mu:
        RANK1_LAUNCHES += 1
    return out


def scale_ulps(x_got, x_want, xb, cb, roots, mloc):
    """How far the renormalization scale behind each live row of ``x_got``
    lies from the one behind ``x_want`` (both updates of ``xb`` under
    ``cb``, ``roots``, ``mloc``), in float32 ulp of the latter: each row's
    scale recovered in float64 as its least-squares ratio to the row before
    the scale, ``(x - b x_root) / s``. Returns a (B, m) float64 tensor, 0 on
    dead rows; held to ``SCALE_ULP_TOL``."""
    m = xb.shape[1]
    live = mloc & (torch.arange(m, device=xb.device) != roots[:, None])
    b, s = covariance.rank1_gates(covariance._col(cb, roots), live)
    pre = ((xb - b[..., None] * covariance._row(xb, roots)) / s[..., None]).double()
    den = torch.clamp((pre * pre).sum(-1), min=1e-300)
    got = (x_got.double() * pre).sum(-1) / den
    want = (x_want.double() * pre).sum(-1) / den
    w32 = want.float()
    spacing = (torch.nextafter(w32, torch.full_like(w32, torch.inf)) - w32).double()
    return torch.where(live, (got - want).abs() / spacing, 0.0)


def ring_update(x_loc, c_loc, x_root, b, s_row, b_col, s_col, live, *, row0: int, n: int,
                reduce=None, inplace: bool = False):
    """The ring's update of one rank's row block (Algorithms 7 and 8 with
    the fit's gates and drift renormalization): ``x_loc: (m_l, n_loc)``
    this rank's sample shard of its rows, ``c_loc: (m_l, m)`` their
    correlations (global rows ``row0 ..``), ``x_root: (n_loc,)`` the root's
    row, ``b``, ``s_row: (m_l,)`` and ``b_col``, ``s_col: (m,)`` the gates
    (``covariance.rank1_gates`` of the root column), ``live: (m_l,)`` bool
    own rows still in U less the root, ``n`` the global sample count.
    ``reduce`` sums the (m_l,) sums of squares in place across the sample
    shards (None: they are whole). Returns ``(x_loc', c_loc')``; with
    ``inplace`` both are written over the inputs, which are returned."""
    global RING_LAUNCHES
    _check("ring_update", x_loc, c_loc, x_root, b, s_row, b_col, s_col)
    m_l, n_loc = x_loc.shape if x_loc.ndim == 2 else (0, 0)
    m = c_loc.shape[-1]
    if (x_loc.ndim != 2 or tuple(c_loc.shape) != (m_l, m) or tuple(x_root.shape) != (n_loc,)
            or tuple(b.shape) != (m_l,) or tuple(s_row.shape) != (m_l,)
            or tuple(b_col.shape) != (m,) or tuple(s_col.shape) != (m,)
            or tuple(live.shape) != (m_l,)):
        raise ValueError(
            f"want x_loc (m_l, n_loc), c_loc (m_l, m), x_root (n_loc,), b and s_row (m_l,), "
            f"b_col and s_col (m,), live (m_l,); got {tuple(x_loc.shape)}, "
            f"{tuple(c_loc.shape)}, {tuple(x_root.shape)}, {tuple(b.shape)}, "
            f"{tuple(s_row.shape)}, {tuple(b_col.shape)}, {tuple(s_col.shape)}, "
            f"{tuple(live.shape)}")
    if live.dtype != torch.bool or live.device != x_loc.device:
        raise TypeError("ring_update takes a bool live mask on x_loc's device")
    if not 0 <= row0 <= m - m_l:
        raise ValueError(f"ring_update: rows {row0}..{row0 + m_l} outside the {m} columns")
    if _fake.on_card(x_loc):
        _fake.note("ring_update", flops(x_loc.numel(), c_loc.numel()))
        return (x_loc, c_loc) if inplace else (torch.empty_like(x_loc), torch.empty_like(c_loc))
    if x_loc.device.type == "cpu":
        x2, c2 = ring_update_ref(x_loc, c_loc, x_root, b, s_row, b_col, s_col, live,
                                 row0=row0, n=n, reduce=reduce)
        return (x_loc.copy_(x2), c_loc.copy_(c2)) if inplace else (x2, c2)
    x_out, c_out = (x_loc, c_loc) if inplace else (torch.empty_like(x_loc), torch.empty_like(c_loc))
    sq = torch.empty((m_l,), dtype=torch.float32, device=x_loc.device)
    live = live.contiguous()
    args = (x_root, b, s_row, b_col, s_col, live, sq)
    if reduce is None:
        launch_ring(x_loc, x_out, c_loc, c_out, *args, RING_FUSED, row0, n)
        launches = 1
    else:
        launch_ring(x_loc, x_loc, c_loc, c_out, *args, RING_SUMS, row0, n)
        reduce(sq)
        launch_ring(x_loc, x_out, c_loc, c_out, *args, RING_SCALE, row0, n)
        launches = 2
    with _count_mu:
        RING_LAUNCHES += launches
    return x_out, c_out
