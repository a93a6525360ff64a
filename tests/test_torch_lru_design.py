"""K4's TMA route (``csrc/rglru_scan.cu``) emulated in PyTorch on the CPU.

The card's kernels cannot run here, so this file walks their design step
by step and holds it bitwise to the plain versions (``ref.lru_scan_ref``,
``ref.lru_scan_bwd_ref``):

- tensor maps over (W, S, B) whose boxes [W_TILE, T_TILE, 1] are
  zero-filled past S and W (and before step 0), and whose stores are
  clipped there;
- the ring: STAGES input stages with a full and an empty barrier each
  (parity waits, the producer running as far ahead as the empty barriers
  let it), OUT_STAGES output stages whose stores read the stage only when
  they complete (``wait_group.read``);
- the backward's reverse walk: h loaded one row earlier, row -1 replaced
  by h0 at t = 0, ``a_next`` and ``dh`` carried across tiles.

A control walks the same design over a 2-D (B * S, W) map and shows the
trap the 3-D map avoids: at a ragged S a batch row's last tile loads the
next row's first steps and stores over them. The route function, which
picks TMA or SIMT before a launch, is tested on CPU tensors.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rglru_scan as kl  # noqa: E402

SOURCE = Path(kl.__file__).parent / "csrc" / "rglru_scan.cu"


def _constant(name):
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text())
    return int(m.group(1))


# The kernel's tiling, read from its source: a block owns W_TILE chains of
# one batch row; a stage holds T steps of every input; STAGES input
# stages, OUT_STAGES output stages.
T = _constant("kTTile")
W_TILE = _constant("kWT")
STAGES = _constant("kStages")
OUT_STAGES = _constant("kOutStages")


# --------------------------------------------------------------- maps --


class Map3D:
    """A tensor map over a contiguous (B, S, W) tensor, dims (W, S, B),
    boxes [wt, T, 1]. One call covers the boxes of every block of a batch
    row: (W-tiles, T, wt)."""

    def __init__(self, x, wt):
        self.x, self.wt = x, wt
        b, s, w = x.shape
        self.nblk = -(-w // wt)

    def _window(self, t0, bi):
        """Rows of the box inside the tensor: (first box row, rows, the
        tensor's rows)."""
        s = self.x.shape[1]
        lo, hi = max(t0, 0), min(t0 + T, s)
        return lo - t0, max(hi - lo, 0), (bi, slice(lo, hi))

    def load(self, t0, bi):
        w = self.x.shape[2]
        box = torch.zeros((self.nblk * self.wt, T), dtype=self.x.dtype)
        j0, n, (b, rows) = self._window(t0, bi)
        box[:w, j0:j0 + n] = self.x[b, rows].T  # zero past S, W and t < 0
        return box.reshape(self.nblk, self.wt, T).transpose(1, 2).contiguous()

    def store(self, stage, t0, bi):
        w = self.x.shape[2]
        flat = stage.transpose(1, 2).reshape(self.nblk * self.wt, T)
        j0, n, (b, rows) = self._window(t0, bi)
        self.x[b, rows] = flat[:w, j0:j0 + n].T  # clipped past S and W


class Map2D(Map3D):
    """The trap: a 2-D map over (B * S, W). Box rows run on into the next
    batch row; only the end of the whole buffer is out of bounds."""

    def _window(self, t0, bi):
        b, s, _ = self.x.shape
        r0 = bi * s + t0
        lo, hi = max(r0, 0), min(r0 + T, b * s)
        flat = self.x.view(b * s, -1)
        return lo - r0, max(hi - lo, 0), (slice(None), slice(lo, hi), flat)

    def load(self, t0, bi):
        w = self.x.shape[2]
        box = torch.zeros((self.nblk * self.wt, T), dtype=self.x.dtype)
        j0, n, (_, rows, flat) = self._window(t0, bi)
        box[:w, j0:j0 + n] = flat[rows].T
        return box.reshape(self.nblk, self.wt, T).transpose(1, 2).contiguous()

    def store(self, stage, t0, bi):
        w = self.x.shape[2]
        flat_stage = stage.transpose(1, 2).reshape(self.nblk * self.wt, T)
        j0, n, (_, rows, flat) = self._window(t0, bi)
        flat[rows] = flat_stage[:w, j0:j0 + n].T


# --------------------------------------------------------------- ring --


class Barrier:
    """An mbarrier's completed phases. ``try_wait.parity(p)`` passes once
    the phase of parity p has completed: the current phase's parity is
    not p."""

    def __init__(self):
        self.phases = 0

    def passes(self, parity):
        return (self.phases & 1) != parity


class Ring:
    """One block's ring (every W-tile of a batch row in lockstep): the
    producer's loads, the consumer's waits and releases, the stores."""

    def __init__(self, in_maps, t0s, out_maps, tiles, wt, dtype, nblk):
        self.in_maps, self.t0s, self.out_maps = in_maps, t0s, out_maps
        self.tiles = tiles
        shape = (nblk, T, wt)
        self.inp = [[torch.zeros(shape, dtype=dtype) for _ in range(STAGES)]
                    for _ in in_maps]
        self.out = [[torch.zeros(shape, dtype=dtype)
                     for _ in range(OUT_STAGES)] for _ in out_maps]
        self.full = [Barrier() for _ in range(STAGES)]
        self.empty = [Barrier() for _ in range(STAGES)]
        self.pending = []  # committed store groups, oldest first
        self.next = 0      # the producer's next tile

    def pump(self, bi):
        """The producer, as far ahead as the empty barriers let it."""
        while self.next < self.tiles:
            k, s = self.next, self.next % STAGES
            if k >= STAGES:
                if not self.empty[s].passes(((k // STAGES) - 1) & 1):
                    return
                assert self.empty[s].phases == k // STAGES
            for i, m in enumerate(self.in_maps):
                self.inp[i][s].copy_(m.load(self.t0s[i](k), bi))
            self.full[s].phases += 1  # expect_tx met by the loads' bytes
            self.next += 1

    def wait_output_stage(self, k):
        """Before tile k's output stage is written: ``wait_group.read``
        until at most OUT_STAGES - 1 store groups still read."""
        if k >= OUT_STAGES:
            while len(self.pending) > OUT_STAGES - 1:
                self.pending.pop(0)()

    def wait_inputs(self, k, bi):
        """Tile k's full barrier, at the parity of its pass over the ring.
        The consumer waits for tile k + 1 before it releases tile k (it
        loads k + 1's first steps while it computes k's last)."""
        self.pump(bi)
        s = k % STAGES
        assert self.full[s].passes((k // STAGES) & 1)
        assert self.full[s].phases == k // STAGES + 1

    def stages(self, k):
        """-> tile k's input stage tiles and output stage tiles."""
        s, o = k % STAGES, k % OUT_STAGES
        return ([st[s] for st in self.inp], [st[o] for st in self.out])

    def release(self, k, t0, bi):
        """The input stage back to the producer; one store group that
        reads the output stages when it completes, not now."""
        self.empty[k % STAGES].phases += 1
        o = k % OUT_STAGES
        stages = [stages[o] for stages in self.out]

        def group():
            for m, stage in zip(self.out_maps, stages):
                m.store(stage, t0, bi)

        self.pending.append(group)
        self.pump(bi)

    def drain(self):
        while self.pending:
            self.pending.pop(0)()


def _poisoned(like):
    """An output buffer that holds NaN until the emulation writes it."""
    return torch.full(like.shape, float("nan"), dtype=like.dtype)


def _lanes(h0, bi, nblk, wt):
    """h0's batch row across the lanes of every block (0 past W)."""
    out = torch.zeros(nblk * wt)
    if h0 is not None:
        out[:h0.shape[1]] = h0[bi]
    return out.reshape(nblk, wt)


def emulate_fwd(a, b, h0, wt, map_cls=Map3D, rows=None):
    """``tma_fwd_kernel`` over every block; batch rows in the order
    ``rows`` (blocks may run in any order)."""
    bsz, s, _ = a.shape
    h = _poisoned(a)
    ma, mb, mh = map_cls(a, wt), map_cls(b, wt), map_cls(h, wt)
    tiles = -(-s // T)
    for bi in rows if rows is not None else range(bsz):
        ring = Ring((ma, mb), (lambda k: k * T,) * 2, (mh,), tiles, wt,
                    a.dtype, ma.nblk)
        state = _lanes(h0, bi, ma.nblk, wt)
        ring.wait_inputs(0, bi)
        for k in range(tiles):
            ring.wait_output_stage(k)
            (ta, tb), (th,) = ring.stages(k)
            ta, tb = ta.float(), tb.float()
            for j in range(T):  # steps past S too: their stores are clipped
                state = ta[:, j] * state + tb[:, j]
                th[:, j] = state.to(a.dtype)
            if k + 1 < tiles:
                ring.wait_inputs(k + 1, bi)
            ring.release(k, k * T, bi)
        ring.drain()
    return h


def emulate_bwd(a, h, g, h0, wt, map_cls=Map3D, rows=None):
    """``tma_bwd_kernel``: tiles from last to first, the h stage one row
    earlier, row -1 replaced by h0 at t = 0, (a_next, dh) carried."""
    bsz, s, w = a.shape
    da, db = _poisoned(a), _poisoned(a)
    ma, mh, mg = map_cls(a, wt), map_cls(h, wt), map_cls(g, wt)
    mda, mdb = map_cls(da, wt), map_cls(db, wt)
    tiles = -(-s // T)
    dh0 = torch.zeros((bsz, w))

    def t0_of(k):
        return (tiles - 1 - k) * T

    for bi in rows if rows is not None else range(bsz):
        ring = Ring((ma, mg, mh),
                    (t0_of, t0_of, lambda k: t0_of(k) - 1), (mda, mdb),
                    tiles, wt, a.dtype, ma.nblk)
        hinit = _lanes(h0, bi, ma.nblk, wt)
        dh = torch.zeros((ma.nblk, wt))
        a_next = torch.zeros((ma.nblk, wt))
        ring.wait_inputs(0, bi)
        for k in range(tiles):
            t0 = t0_of(k)
            ring.wait_output_stage(k)
            (ta, tg, th), (tda, tdb) = ring.stages(k)
            ta, tg, th = ta.float(), tg.float(), th.float()
            for j in range(T - 1, -1, -1):
                dh = tg[:, j] + a_next * dh
                h_prev = hinit if (j == 0 and t0 == 0) else th[:, j]
                tda[:, j] = (dh * h_prev).to(a.dtype)
                tdb[:, j] = dh.to(a.dtype)
                a_next = ta[:, j]
            if k + 1 < tiles:
                ring.wait_inputs(k + 1, bi)
            ring.release(k, t0, bi)
        ring.drain()
        dh0[bi] = (a_next * dh).reshape(-1)[:w]
    return da, db, dh0


# ------------------------------------------------------------- inputs --


def _inputs(b, s, w, dtype, with_h0, seed=0):
    rng = np.random.default_rng(seed)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((b, s, w))))
    x, g = rng.standard_normal((2, b, s, w))
    h0 = rng.standard_normal((b, w)) if with_h0 else None

    def t(v):
        return torch.from_numpy(v.astype(np.float32)).to(dtype)

    return t(a), t(x), t(g), None if h0 is None else t(h0).float()


def _aligned_w(base, dtype):
    """A width past ``base`` whose rows are 16-byte multiples (the TMA
    route's) and not a multiple of 32: base + 4 in f32, base + 8 in bf16."""
    return base + (4 if dtype == torch.float32 else 8)


def _equal(got, want):
    return all(g.dtype == w.dtype and torch.equal(g, w)
               for g, w in zip(got, want))


# -------------------------------------------------------------- tests --


def test_constants_match_the_cuda_source():
    """The emulation's tiling, read from ``rglru_scan.cu``, is the design's:
    a lane of the consumer warp a chain, whole register chunks a stage, and
    at recurrentgemma_2b's shape (1, 4096, 2560) f32 at least 4 MB of the
    forward's loads in flight."""
    assert W_TILE == 32
    assert T % _constant("kU") == 0
    blocks = -(-2560 // W_TILE)
    in_flight = blocks * 2 * STAGES * T * W_TILE * 4
    assert in_flight >= 4e6, in_flight


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,w_base", [
    (1, 5, 32),      # S < T_TILE, W % W_TILE != 0
    (2, 130, 32),    # S % T_TILE != 0
    (1, 70, 2560),   # an aligned W past 2560
    (3, 100, 64),    # three batch rows at a ragged S
    (2, 128, 64),    # S a multiple of T_TILE
    (3, 1, 64),      # one step
    (1, 65, 96),     # one step past a tile, W a multiple of W_TILE
])
def test_tma_walk_bitwise_to_plain(b, s, w_base, dtype, with_h0):
    w = _aligned_w(w_base, dtype) if w_base in (32, 2560) else w_base
    a, x, g, h0 = _inputs(b, s, w, dtype, with_h0, seed=s + w)
    rows = range(b - 1, -1, -1)  # a later row's block first
    h = emulate_fwd(a, x, h0, W_TILE, rows=rows)
    want_h = ref.lru_scan_ref(a, x, h0)
    assert _equal((h,), (want_h,))
    got = emulate_bwd(a, want_h, g, h0, W_TILE, rows=rows)
    want = ref.lru_scan_bwd_ref(a, want_h, g, h0)
    assert _equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_2d_map_corrupts_the_next_batch_row(dtype):
    """The control: over a 2-D (B * S, W) map, a batch row's ragged last
    tile loads the next row's first steps and stores over them. With the
    rows' blocks finishing last row first, row b's tail overwrites row
    b + 1's first h; the backward reads row b + 1's a and g into row b's
    reverse scan whatever the order. The 3-D map is exact in both orders,
    and the 2-D map is exact when S is a multiple of the tile."""
    b, s, w = 3, 100, 64
    a, x, g, h0 = _inputs(b, s, w, dtype, True, seed=1)
    want_h = ref.lru_scan_ref(a, x, h0)
    want = ref.lru_scan_bwd_ref(a, want_h, g, h0)
    for rows in (range(b), range(b - 1, -1, -1)):
        assert _equal((emulate_fwd(a, x, h0, W_TILE, rows=rows),), (want_h,))
        assert _equal(emulate_bwd(a, want_h, g, h0, W_TILE, rows=rows), want)

    h2 = emulate_fwd(a, x, h0, W_TILE, Map2D, rows=range(b - 1, -1, -1))
    bad = ~(h2 == want_h)
    assert bool(bad.any())
    assert not bool(bad[0].any())  # row 0 is written last and is right
    overrun = T - s % T  # steps of row b + 1 under row b's last tile
    # every lane of rows 1 and 2 is wrong from step 0; the wrong state
    # decays toward the right one (|a| < 1), but never past the overrun
    assert bool(bad[1:, 0].all()) and not bool(bad[1:, overrun:].any())

    _, db2, _ = emulate_bwd(a, want_h, g, h0, W_TILE, Map2D, rows=range(b))
    # rows 0 and 1 start their reverse scan from row b + 1's a and g: dh
    # is wrong at the last step of every lane (and decays toward the right
    # one going back); the last row's overrun falls past the buffer's end
    # and is zero-filled
    assert bool((db2[:b - 1, s - 1] != want[1][:b - 1, s - 1]).all())
    assert torch.equal(db2[b - 1], want[1][b - 1])

    a, x, g, h0 = _inputs(2, 2 * T, w, dtype, True, seed=2)
    want_h = ref.lru_scan_ref(a, x, h0)
    h2 = emulate_fwd(a, x, h0, W_TILE, Map2D, rows=range(1, -1, -1))
    assert _equal((h2,), (want_h,))
    assert _equal(emulate_bwd(a, want_h, g, h0, W_TILE, Map2D),
                  ref.lru_scan_bwd_ref(a, want_h, g, h0))


def test_ring_stores_read_the_stage_late():
    """The emulated stores read an output stage when they complete. Without
    the wait_group.read before a stage is written again, the walk must go
    wrong: the emulation would catch a missing or short wait."""
    a, x, _, h0 = _inputs(1, 5 * T, 40, torch.float32, True, seed=3)
    want = ref.lru_scan_ref(a, x, h0)
    assert _equal((emulate_fwd(a, x, h0, W_TILE),), (want,))

    class LateRing(Ring):
        def wait_output_stage(self, k):  # no wait_group.read
            pass

    original = Ring
    try:
        globals()["Ring"] = LateRing
        late = emulate_fwd(a, x, h0, W_TILE)
    finally:
        globals()["Ring"] = original
    assert not torch.equal(late, want)


def _view(shape, dtype, offset_bytes):
    """A contiguous CPU tensor whose data pointer is ``offset_bytes`` past
    a 16-byte boundary."""
    size = torch.empty((), dtype=dtype).element_size()
    n = int(np.prod(shape))
    buf = torch.empty(n + 16 // size, dtype=dtype)
    assert buf.data_ptr() % 16 == 0
    view = buf[offset_bytes // size:offset_bytes // size + n].view(shape)
    assert view.is_contiguous() and view.data_ptr() % 16 == offset_bytes % 16
    return view


@pytest.mark.parametrize("shape,dtype,offset,want", [
    ((1, 4096, 2560), torch.float32, 0, "tma"),   # recurrentgemma_2b's
    ((1, 4096, 2560), torch.bfloat16, 0, "tma"),
    ((2, 4100, 2560), torch.float32, 0, "tma"),
    ((2, 37, 2560), torch.bfloat16, 0, "tma"),
    ((3, 1000, 100), torch.float32, 0, "tma"),    # 400-byte rows
    ((3, 1000, 100), torch.bfloat16, 0, "simt"),  # 200-byte rows
    ((1, 64, 2564), torch.float32, 0, "tma"),
    ((1, 64, 2564), torch.bfloat16, 0, "simt"),
    ((1, 64, 2568), torch.bfloat16, 0, "tma"),
    ((2, 37, 45), torch.float32, 0, "simt"),
    ((1, 5, 33), torch.bfloat16, 0, "simt"),
    ((3, 16, 1), torch.float32, 0, "simt"),
    ((2, 300, 2560), torch.float32, 4, "simt"),   # a view 4 bytes off
    ((2, 300, 2560), torch.bfloat16, 4, "simt"),
    ((2, 300, 2560), torch.float32, 8, "simt"),
    ((2, 300, 2560), torch.float32, 16, "tma"),   # a view 16 bytes on
])
def test_route_by_shape_dtype_and_alignment(shape, dtype, offset, want):
    x = _view(shape, dtype, offset)
    aligned = _view(shape, dtype, 0)
    assert kl.route(x, aligned, aligned) == want
    assert kl.route(aligned, aligned, x) == want  # any mapped tensor counts


def test_route_leaves_the_cpu_path_alone():
    """The launchers take CUDA tensors only; on the CPU ``ops`` runs the
    plain versions whatever the route would be."""
    from repro_torch.kernels import ops

    a, x, g, h0 = _inputs(1, 70, 2564, torch.float32, True)
    ops.reset_launches()
    assert torch.equal(ops.lru_scan_fwd(a, x, h0), ref.lru_scan_ref(a, x, h0))
    assert kl.ROUTE_LAUNCHES == {"tma": 0, "simt": 0}
    with pytest.raises(ValueError, match="CUDA"):
        kl.fwd(a, x, h0)
    with pytest.raises(ValueError, match="CUDA"):
        kl.bwd(a, x, g, h0)
