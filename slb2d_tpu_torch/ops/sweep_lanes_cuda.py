"""The lane-packed sweep kernel's runner (csrc/sweep_lanes.cu): a whole
parameter sweep with its points packed along the columns.

The port of the JAX package's lane-packed Pallas runner
(slb2d_tpu/ops/sweep_pallas.py:make_sweep_pallas_runner, kernel B4).  The
points go in chunks of at most ``max_points``; the last chunk is padded
with copies of its last point whose averaging window never opens (t_end =
-inf).  A chunk of CB points is one packed state (NHP, CB·MP): point s owns
the columns [s·MP, (s+1)·MP).  Every step evaluates each point's trig from
the loop t all points share (t <- fl(t + dt) from 0: dt and t_start are
not sweepable), advances both grids, and updates per-lane (per-column)
av() and loop-exit capture rows; nothing reduces across lanes during the
run.  After it the host sums each point's segment once, in float64
(``finish_chunk``): the av count is lane 0's, the quadratures are
the sums of (Kahan sum − compensation).

Same semantics as ParameterSweep: a shared step count, each point's
averaging window [t_start, t_end_s) and the capture of its last live
step's instantaneous observables.  ``observables`` turns a runner's result
into ParameterSweep.run()'s per-point dict.

Two forms of the kernel compute the same function (csrc/sweep_lanes.cu):
the cluster form runs a chunk's whole call in one launch with each point
held in the shared memory of a thread-block cluster; the streaming form,
two launches per step over the chunk's state in device memory, serves
points no portable cluster holds.  ``lanes_cluster_plan`` decides which
runs, before launching.

On a CPU sweep the runner runs the kernel's plain version,
``run_lanes_plain``; on a CUDA sweep it launches the kernel or raises;
nothing falls back.  float32 only, as the JAX kernel.  Routing does not
send sweeps here: ParameterSweep keeps its engines, as the JAX package
does; the bench's ``sweep lanes`` mode reaches this kernel.
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import torch

from . import stencil
from .stencil import CAP_KEYS

# per-point columns of the (CB, SEG_COLS) table (csrc/sweep_lanes.cu SEG_*)
(SEG_EDC, SEG_EOM, SEG_B, SEG_BDT, SEG_OMEGA, SEG_EGATE, SEG_TEND) = range(7)
SEG_COLS = 8

# packed weight rows (csrc/sweep_lanes.cu W_*)
W_ROWS = ("w_av", "w_av_phi", "w_d4", "w_d4_phi")

# shared scalars of the kernel's params vector, then t_start and the loop
# t of the first step
SCALAR_FIELDS = ("dt", "nu", "nu2", "nu_tilde")

# kernel launches of the streaming form per step: the main half-step, the
# half-grid half-step with the av and capture rows
LAUNCHES_PER_STEP = 2
# kernel launches of the cluster form per call (advance), whatever its
# steps
LAUNCHES_PER_CALL = 1

# The cluster form's shared-memory budget (csrc/sweep_lanes.cu, whose
# constants of the same names tests/test_torch_sweep_lanes_cluster.py holds
# to these): a block's opt-in shared memory on an H100 (227 KB), the
# portable cluster sizes (a size must also divide NHP), a rank's slab
# arrays (a, b, a_hs, b_hs), its rows of a0 and a0_ghost (staged where
# they fit), the point's rows of one column each (av 8, capture 4, the
# weights 4, phi 1), and the floats of the static trig buffer.
SMEM_LIMIT = 232448
CLUSTER_SIZES = tuple(range(1, 9))
SLAB_ARRAYS = 4
A0_ARRAYS = 2
COLUMN_ROWS = 17
TRIG_SCRATCH = 16
# the kernel's return code when no cluster of a launch fits on the card
NO_ACTIVE_CLUSTER = -1
# Clusters of each size of the cluster form that run at once on an H100
# 80GB HBM3 (one 1024-thread block per SM, whatever its shared memory):
# cudaOccupancyMaxActiveClusters as chip_smoke.py's phase 16 prints it
# ("lanes sizes"; PERF.md §6).  A CPU runner records the plan of this
# card; a CUDA runner asks its own.
H100_ACTIVE_CLUSTERS = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15,
                        8: 15}

# kernel launches made by every runner of this process (each runner also
# counts its own in .launches), in all and by form: a caller that wants to
# show a run went through the kernel resets these before the run and reads
# them after
launch_count = 0
cluster_launch_count = 0      # lanes_cluster
streaming_launch_count = 0    # lanes_half_step


def _within_budget(smem):
    return smem + TRIG_SCRATCH * 4 <= SMEM_LIMIT


def stages_a0(NHP: int, MP: int, cluster_size: int) -> bool:
    """Whether the cluster form's ranks stage their rows of a0 and a0_ghost
    in shared memory: wherever they fit beside the slab (at N=40 M=500 for
    6 or more blocks a point, not for 2)."""
    rows = NHP // cluster_size
    return _within_budget(((SLAB_ARRAYS + A0_ARRAYS) * rows + COLUMN_ROWS)
                          * MP * 4)


def cluster_smem_bytes(NHP: int, MP: int, cluster_size: int):
    """The dynamic shared memory of one rank of a cluster of cluster_size
    blocks holding an (NHP, MP) float32 point, or None where that cluster
    cannot hold it: not a portable size, NHP not split into equal slabs of
    at least 2 rows (rank 0 holds rows 0 and 1, which the av and capture
    rows read), or the slab, the column rows and the trig buffer past
    SMEM_LIMIT.  With the a0 rows where stages_a0."""
    if cluster_size not in CLUSTER_SIZES or NHP % cluster_size:
        return None
    rows = NHP // cluster_size
    if rows < 2:
        return None
    smem = (SLAB_ARRAYS * rows + COLUMN_ROWS) * MP * 4
    if not _within_budget(smem):
        return None
    if stages_a0(NHP, MP, cluster_size):
        smem += A0_ARRAYS * rows * MP * 4
    return smem


def lanes_cluster_plan(NHP: int, MP: int, CB: int, active=None):
    """(cluster size, shared-memory bytes a block) of the cluster form for
    a chunk of CB (NHP, MP) points, or None where no portable cluster
    holds a point (the streaming form runs those; e.g. N=100 M=4000, 6.8
    MB a point).  active(cs) is the number of clusters of cs blocks that
    run at once on the card (H100_ACTIVE_CLUSTERS by default).  A chunk
    runs in ceil(CB / active(cs)) waves of R = NHP / cs rows a block, and
    a block's step takes about its cells' time, so the plan takes the size
    with the fewest waves x rows, the larger size on a tie.  At N=40 M=500
    (NHP=48, MP=512) on an H100: CB=16 -> 6 blocks of 8 rows in one wave
    (16 clusters of 8 would need two: 15 run at once), CB=64 -> 2 blocks
    of 24 rows."""
    active = active or H100_ACTIVE_CLUSTERS.__getitem__
    best = None
    for cs in CLUSTER_SIZES:
        smem = cluster_smem_bytes(NHP, MP, cs)
        at_once = active(cs) if smem is not None else 0
        if at_once < 1:
            continue
        cost = (-(-CB // at_once) * (NHP // cs), -cs)
        if best is None or cost < best[0]:
            best = cost, (cs, smem)
    return None if best is None else best[1]


def form_info(cluster_size: int, NHP: int, MP: int, n_points: int) -> dict:
    """What a form of the kernel takes on the current card for a chunk of
    n_points (NHP, MP) points: registers and local (spill) bytes a thread,
    dynamic shared memory a block, and the clusters (the streaming form,
    cluster_size 0: blocks) that run at once on the whole card.  Builds
    the kernels first; needs a card."""
    import ctypes
    from . import _build
    out = (ctypes.c_int * 4)()
    rc = _build.load().cdll.slb_lanes_form_info(
        cluster_size, NHP, MP, n_points, ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"lane-packed kernel form query (cluster_size="
                           f"{cluster_size}, NHP={NHP}, MP={MP}) failed: "
                           f"cudaError_t {rc}")
    return dict(registers=out[0], local_bytes=out[1], smem_bytes=out[2],
                active_clusters=out[3])


@dataclasses.dataclass
class LaneState:
    """A chunk's packed state: the four (NHP, CB·MP) arrays, the per-lane
    av rows (8, CB·MP: count, the running means of v_dr, v_y, m_x, the two
    Kahan sums and their compensations) and capture rows (4, CB·MP, in
    CAP_KEYS order)."""
    a: torch.Tensor
    b: torch.Tensor
    a_hs: torch.Tensor
    b_hs: torch.Tensor
    av: torch.Tensor
    cap: torch.Tensor

    def clone(self) -> "LaneState":
        return LaneState(**{f.name: getattr(self, f.name).clone()
                            for f in dataclasses.fields(self)})


@dataclasses.dataclass
class LanePack:
    """One chunk's constants on the sweep's device."""
    n_live: int                     # points of the sweep in this chunk
    consts: stencil.StencilConsts   # packed: a0, a0_ghost (NHP, CB·MP);
                                    # phi, column masks and per-point
                                    # E_dc, E_omega, omega, B, bdt as
                                    # (1, CB·MP) rows; shared scalars
    seg: torch.Tensor               # (CB, SEG_COLS) per-point table
    w: torch.Tensor                 # (4, CB·MP) weight rows, W_ROWS order
    edge_a: torch.Tensor            # (CB, NHP) bootstrap column M+1 of
    edge_b: torch.Tensor            # each point's a_hs, b_hs
    state0: LaneState               # the bootstrap state


def _row(x, MP):
    """(CB,) per-point values -> a (1, CB·MP) per-segment row."""
    return x.repeat_interleave(MP).reshape(1, -1)


def pack_chunk(sweep, idx, CB, init) -> LanePack:
    """The chunk of the sweep's points idx, padded to CB with copies of
    the last, from the sweep's batched bootstrap `init`
    (ParameterSweep._initial_states)."""
    base = sweep.base
    D = base.np_dtype
    dev = sweep.device
    NHP, MP = base.NHP, base.MP
    n_live = len(idx)
    idx = list(idx) + [idx[-1]] * (CB - n_live)
    models = [sweep.models[i] for i in idx]
    seg = np.zeros((CB, SEG_COLS), D)
    t_start = D(sweep.cfg.t_start)
    for s, m in enumerate(models):
        seg[s, SEG_EDC] = m.E_dc
        seg[s, SEG_EOM] = m.E_omega
        seg[s, SEG_B] = m.B
        seg[s, SEG_BDT] = m.bdt
        seg[s, SEG_OMEGA] = m.omega
        seg[s, SEG_EGATE] = 1 if float(m.E_omega) > 0 else 0
        # padded lanes' windows never open and their captures never fire
        seg[s, SEG_TEND] = D(t_start + m.T) if s < n_live else -np.inf
    seg = torch.as_tensor(seg, device=dev)

    def packed(x):                # (CB, NHP, MP) -> (NHP, CB·MP)
        return torch.as_tensor(x, device=dev).permute(1, 0, 2).reshape(
            NHP, CB * MP).contiguous()

    def tiled(x):                 # (MP,) or (1, MP) -> (1, CB·MP)
        return torch.as_tensor(np.asarray(x), device=dev).reshape(
            1, MP).repeat(1, CB)

    c = dataclasses.replace(
        stencil.consts_from_model(base, dev),
        a0=packed(np.stack([m.a0 for m in models])),
        a0_ghost=packed(np.stack([m.a0_ghost for m in models])),
        phi=tiled(base.phi).reshape(-1), col_main=tiled(base.col_main),
        col_half=tiled(base.col_half),
        col_edge=tiled(np.arange(MP) == base.M + 1),
        w_av=tiled(base.w_av).reshape(-1),
        w_av_phi=tiled(base.w_av_phi).reshape(-1),
        **{f: _row(seg[:, k], MP) for f, k in (
            ("E_dc", SEG_EDC), ("E_omega", SEG_EOM), ("B", SEG_B),
            ("bdt", SEG_BDT), ("omega", SEG_OMEGA))})
    w = torch.cat([tiled(getattr(base, k)) for k in W_ROWS]).contiguous()
    zeros = torch.zeros((8 + 4, CB * MP), dtype=c.a0.dtype, device=dev)
    state0 = LaneState(a=packed(init.a[idx]), b=packed(init.b[idx]),
                       a_hs=packed(init.a_hs[idx]),
                       b_hs=packed(init.b_hs[idx]),
                       av=zeros[:8].clone(), cap=zeros[8:].clone())
    edge = [init.a_hs[idx, :, base.M + 1].contiguous(),
            init.b_hs[idx, :, base.M + 1].contiguous()]
    return LanePack(n_live, c, seg, w, *edge, state0)


def run_lanes_plain(pack: LanePack, st: LaneState, n_steps: int,
                    step0: int = 0, t0: float = 0.0) -> LaneState:
    """The kernel's plain PyTorch version: n_steps of B4's per-step math
    on the packed tensors, from global step step0 at loop t t0 (the loop t
    after step0 steps).  Both half-steps go through
    stencil.apply_half_step in the reciprocal form with the per-segment
    rows of pack.consts, torch.roll wrapping over the packed axis as the
    JAX kernel's rolls do; every point's trig is torch.cos/sin of its
    omega row times the carried t.  The ghost fill and the edge column
    are added with the parity factor gf, as the JAX kernel adds them, and
    the av and capture rows follow its per-lane recurrences.  Returns a
    new LaneState."""
    c = pack.consts
    D = st.a.dtype
    dev = st.a.device
    CB = pack.seg.shape[0]
    NHP, BMP = st.a.shape
    MP = BMP // CB
    dt = c.dt
    w = pack.w
    egate = _row(pack.seg[:, SEG_EGATE], MP)
    tend = _row(pack.seg[:, SEG_TEND], MP)
    # the edge vectors as B4's one-hot (NHP, CB·MP) tables: column M+1 of
    # each segment, in segment order
    bea = torch.zeros((NHP, BMP), dtype=D, device=dev)
    beb = torch.zeros((NHP, BMP), dtype=D, device=dev)
    bea[:, c.col_edge[0]] = pack.edge_a.t()
    beb[:, c.col_edge[0]] = pack.edge_b.t()
    a, b, ahs, bhs, av, cap = st.a, st.b, st.a_hs, st.b_hs, st.av, st.cap
    t = torch.tensor(t0, dtype=D, device=dev)
    for i in range(n_steps):
        gf = 1.0 if (step0 + i + 1) % 2 == 0 else 0.0
        t_hs = t + dt / 2
        a_new, b_new = stencil.apply_half_step(
            c, a, b, ahs, bhs, torch.cos(c.omega * t),
            torch.cos(c.omega * (t + dt)), main=True, use_reciprocal=True)
        a_new = a_new + gf * c.a0_ghost
        ahs, bhs = stencil.apply_half_step(
            c, ahs, bhs, a_new, b_new, torch.cos(c.omega * t_hs),
            torch.cos(c.omega * (t_hs + dt)), main=False,
            use_reciprocal=True)
        ahs = ahs + gf * bea
        bhs = bhs + gf * beb
        a, b = a_new, b_new

        av, cap = lane_rows_step(c.omega, c.t_start, dt, w, egate, tend,
                                 av, cap, a, b, t)
        t = t + dt
    return LaneState(a=a, b=b, a_hs=ahs, b_hs=bhs, av=av, cap=cap)


def lane_rows_step(omega, t_start, dt, w, egate, tend, av, cap, a, b, t):
    """One step of the per-lane av() and capture recurrences
    (sweep_pallas.py:137-174) at loop t from rows 0-1 of the new a, b:
    (new av (8, L), new cap (4, L)).  Every argument but t_start, dt and t
    is per lane: omega, egate, tend (1, L) rows, w the (4, L) weight rows,
    av and cap the rows of the same lanes; a column's result depends on
    that column alone."""
    D = av.dtype
    one = torch.ones((), dtype=D, device=av.device)
    live = (t < tend).to(D)
    g = live * egate * (t >= t_start).to(D)
    x_dr = b[1:2] * w[0:1]
    x_vy = a[0:1] * w[1:2]
    x_mx = a[1:2] * w[0:1]
    count = av[0:1] + g
    den = torch.where(count > 0, count, one)
    cos_av = torch.cos(omega * t)
    sin_av = torch.sin(omega * t)
    y4 = cos_av * x_dr * dt - av[6:7]
    t4 = av[4:5] + y4
    c4 = (t4 - av[4:5]) - y4
    y5 = sin_av * x_dr * dt - av[7:8]
    t5 = av[5:6] + y5
    c5 = (t5 - av[5:6]) - y5
    gb = g > 0
    av = torch.cat([
        count,
        av[1:2] + g * (x_dr - av[1:2]) / den,
        av[2:3] + g * (x_vy - av[2:3]) / den,
        av[3:4] + g * (x_mx - av[3:4]) / den,
        torch.where(gb, t4, av[4:5]), torch.where(gb, t5, av[5:6]),
        torch.where(gb, c4, av[6:7]), torch.where(gb, c5, av[7:8])])
    lb = live > 0
    cap = torch.cat([
        torch.where(lb, b[1:2] * w[2:3], cap[0:1]),
        torch.where(lb, a[0:1] * w[3:4], cap[1:2]),
        torch.where(lb, a[1:2] * w[2:3], cap[2:3]),
        torch.where(lb, a[0:1] * w[0:1], cap[3:4])])
    return av, cap


class LanesRunner:
    """runner() -> (av (B, 8), cap dict of (B,) arrays over CAP_KEYS, the
    packed final state as four host (NHP, B·MP) arrays), as the JAX
    runner returns them.  Its parts, for callers that split a run:
    start(k) is chunk k's bootstrap state, advance(k, st, n, step0) runs n
    steps from global step step0 (the kernel in place on CUDA, the plain
    version on the CPU), and finish_chunk(runner.packs[k], st) fetches the
    chunk once and sums its segments.  `launches` counts this runner's
    kernel launches.

    The form follows lanes_cluster_plan for the chunk size CB and the
    clusters the card runs at once (a CPU runner records an H100's): form
    "cluster" with cluster_size blocks a point and smem_bytes of shared
    memory a block, or form "streaming" (cluster_size 0) where no cluster
    holds a point.  cluster_size forces a size (0: the streaming form);
    one no cluster can take raises."""

    def __init__(self, sweep, max_points=16, cluster_size=None):
        base = sweep.base
        if base.np_dtype != np.float32:
            raise ValueError("the lane-packed sweep kernel is float32-only")
        if max_points < 1:
            raise ValueError(f"max_points={max_points} < 1")
        dev = sweep.device
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"lane-packed sweep on {dev}: no CUDA device "
                               f"is available")
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"lane-packed sweep: unsupported device {dev}")
        self.sweep, self.base = sweep, base
        self.CB = min(max_points, sweep.B)
        NHP, MP = base.NHP, base.MP
        if cluster_size is None:
            active = None
            if dev.type == "cuda":
                def active(cs):
                    with torch.cuda.device(dev):
                        return form_info(cs, NHP, MP, self.CB)[
                            "active_clusters"]
            plan = lanes_cluster_plan(NHP, MP, self.CB, active)
        elif cluster_size == 0:
            plan = None
        else:
            smem = cluster_smem_bytes(NHP, MP, cluster_size)
            if smem is None:
                raise ValueError(
                    f"lane-packed sweep: a cluster of {cluster_size} blocks "
                    f"cannot hold an (NHP={NHP}, MP={MP}) point (sizes "
                    f"{CLUSTER_SIZES}, >= 2 rows a block, {SMEM_LIMIT} "
                    f"bytes)")
            plan = cluster_size, smem
        self.form = "streaming" if plan is None else "cluster"
        self.cluster_size, self.smem_bytes = plan or (0, 0)
        init = sweep._initial_states()
        self.packs = [pack_chunk(sweep, range(i, min(i + max_points,
                                                      sweep.B)),
                                  self.CB, init)
                      for i in range(0, sweep.B, max_points)]
        D = base.np_dtype
        self.params = np.array([getattr(base, k) for k in SCALAR_FIELDS]
                               + [D(sweep.cfg.t_start), 0.0], D)
        self.launches = 0

    def __call__(self):
        avs, caps, states = [], [], []
        for k, pack in enumerate(self.packs):
            st = self.advance(k, self.start(k), self.sweep.n_steps)
            av, cap, state = finish_chunk(pack, st)
            avs.append(av)
            caps.append(cap)
            states.append(state)
        cap = np.concatenate(caps, axis=1)
        return (np.concatenate(avs, axis=0), dict(zip(CAP_KEYS, cap)),
                tuple(np.concatenate([s[i] for s in states], axis=1)
                      for i in range(4)))

    def start(self, k) -> LaneState:
        return self.packs[k].state0.clone()

    def loop_t(self, step0):
        """The loop t after step0 steps from 0 (sequential accumulation
        in float32, as the kernel carries it)."""
        from ..runtime.schedule import accum_sequence
        D = self.base.np_dtype
        return float(accum_sequence(0.0, self.base.dt, step0, D)[-1])

    def advance(self, k, st: LaneState, n_steps, step0=0) -> LaneState:
        pack = self.packs[k]
        t0 = self.loop_t(step0)
        dev = st.a.device
        if dev.type == "cpu":
            return run_lanes_plain(pack, st, n_steps, step0, t0)
        if dev.type != "cuda":
            raise ValueError(f"lane-packed sweep: unsupported device {dev}")
        self._launch(pack, st, n_steps, step0, t0)
        return st

    def _launch(self, pack, st, n, step0, t0):
        from . import _build
        global launch_count, cluster_launch_count, streaming_launch_count
        CB, base = self.CB, self.base
        NHP, BMP = base.NHP, CB * base.MP
        c = pack.consts
        tensors = dict(a=st.a, b=st.b, a_hs=st.a_hs, b_hs=st.b_hs,
                       av=st.av, cap=st.cap, a0=c.a0, a0_ghost=c.a0_ghost,
                       phi=c.phi, w=pack.w, seg=pack.seg, edge_a=pack.edge_a,
                       edge_b=pack.edge_b)
        shapes = dict(a=(NHP, BMP), b=(NHP, BMP), a_hs=(NHP, BMP),
                      b_hs=(NHP, BMP), av=(8, BMP), cap=(4, BMP),
                      a0=(NHP, BMP), a0_ghost=(NHP, BMP), phi=(BMP,),
                      w=(len(W_ROWS), BMP), seg=(CB, SEG_COLS),
                      edge_a=(CB, NHP), edge_b=(CB, NHP))
        dev = st.a.device
        for name, t in tensors.items():
            if (t.device != dev or t.dtype != torch.float32
                    or tuple(t.shape) != shapes[name]
                    or not t.is_contiguous()):
                raise ValueError(
                    f"lane-packed sweep: {name} must be a contiguous "
                    f"float32 {shapes[name]} tensor on {dev}, got "
                    f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if n == 0:
            return
        params = self.params.copy()
        params[-1] = t0
        lib = _build.load()
        args = [*(t.data_ptr() for t in tensors.values()),
                params.ctypes.data, CB, base.N, base.M, NHP, base.MP, int(n),
                int(step0) % 2]
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            if self.form == "cluster":
                rc = lib.cdll.slb_lanes_cluster_f32(*args, self.cluster_size,
                                                    stream)
            else:
                rc = lib.cdll.slb_lanes_chunk_f32(*args, stream)
        if rc == NO_ACTIVE_CLUSTER:
            raise RuntimeError(
                f"lane-packed sweep kernel: no cluster of "
                f"{self.cluster_size} blocks with {self.smem_bytes} bytes of "
                f"shared memory fits on {torch.cuda.get_device_name(dev)}")
        if rc != 0:
            raise RuntimeError(f"lane-packed sweep kernel launch ({self.form} "
                               f"form, cluster_size {self.cluster_size}) "
                               f"failed: cudaError_t {rc}")
        if self.form == "cluster":
            k = LAUNCHES_PER_CALL
            cluster_launch_count += k
        else:
            k = LAUNCHES_PER_STEP * n
            streaming_launch_count += k
        self.launches += k
        launch_count += k


def finish_chunk(pack: LanePack, st: LaneState):
    """(av (n_live, 8), cap (4, n_live), state: four host (NHP, n_live·MP)
    arrays) of a chunk: one fetch, then each point's segment summed in
    float64 and cast back (sweep_pallas.py:318-346); the av count is lane
    0's, columns 4-5 fold the Kahan compensations in and columns 6-7 stay
    0."""
    CB = pack.seg.shape[0]
    NHP, BMP = st.a.shape
    MP = BMP // CB
    n = pack.n_live
    flat = torch.cat([x.reshape(-1) for x in (
        st.av, st.cap, st.a, st.b, st.a_hs, st.b_hs)]).cpu().numpy()
    D = flat.dtype
    avr = flat[:8 * BMP].astype(np.float64).reshape(8, CB, MP)
    capr = flat[8 * BMP:12 * BMP].astype(np.float64).reshape(4, CB, MP)
    arrays = flat[12 * BMP:].reshape(4, NHP, BMP)
    av = np.zeros((n, 8), D)
    av[:, 0] = avr[0, :n, 0]
    av[:, 1:4] = avr[1:4, :n].sum(-1).T
    av[:, 4] = (avr[4, :n] - avr[6, :n]).sum(-1)
    av[:, 5] = (avr[5, :n] - avr[7, :n]).sum(-1)
    cap = capr[:, :n].sum(-1).astype(D)
    return av, cap, tuple(x[:, :n * MP] for x in arrays)


def make_sweep_lanes_runner(sweep, max_points=16,
                            cluster_size=None) -> LanesRunner:
    """The B4 runner of a ParameterSweep (see LanesRunner); sweeps of more
    than max_points points run in chunks of max_points."""
    return LanesRunner(sweep, max_points=max_points,
                       cluster_size=cluster_size)


def run_sweep_lanes(sweep, max_points=16):
    """One-shot make_sweep_lanes_runner(sweep, max_points)()."""
    return make_sweep_lanes_runner(sweep, max_points=max_points)()


def observables(sweep, av, cap):
    """ParameterSweep.run()'s per-point dict (av_count, the averages, A,
    Asin, the loop-exit observables, norm) from a runner's av and cap."""
    return sweep._finalize(
        types.SimpleNamespace(av=torch.as_tensor(av)),
        {k: torch.as_tensor(v) for k, v in cap.items()})
