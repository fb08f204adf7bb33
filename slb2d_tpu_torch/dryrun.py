"""The driver's entry points on the port: ``entry()`` and
``dryrun_multichip(n)``, the port of ``__graft_entry__.py``.

entry(): one full solver time step (both stencil half-steps and the
observable accumulation on the device) on the flagship single-run config
(BASELINE #4: n-harmonics=100, g-grid=4000, float32).

dryrun_multichip(n): six checks over a ("sweep", "space") mesh of n slots
(parallel/mesh.default_split), at the JAX dryrun's tiny shapes (N=6,
M=29, MP=128; B = 2 points per sweep slot; t-start=0.05):

  1. one combined sweep x space step of the batched engine against the
     same step on one device: the state bit for bit, av at AV_TOL (the
     order of the sums over m);
  2. the sharded driver (Simulation, shards = the space slots, the plain
     scan) over one exact-schedule chunk against the unsharded run: the
     state bit for bit, av at AV_TOL;
  3. the combined-mesh ParameterSweep against the one-device sweep: the
     captured state bit for bit, the table at AV_TOL;
  4. B2's sharded form over the "space" slots (M = 128 * space - 3, K=8,
     one 24-step chunk) against the unsharded tiling form's plain
     version: the state bit for bit, av at AV_TOL;
  5. B3 shared-omega over a "sweep" mesh against the batched engine on
     one device, at SWEEP_TOL;
  6. B3 per-omega over the "sweep" mesh, likewise.

The mesh's slots are `device` repeated n times: on a card n slots of
cuda:<k>, where checks 4-6 launch B2's sharded form and both modes of B3
and their launches are counted; on the CPU n CPU slots, where the same
runners run the kernels' plain versions (the counterpart of the JAX
dryrun's interpret mode on its virtual CPU devices).  Unlike the JAX
dryrun's, checks 3, 5 and 6 drive at 10x its frequencies (omega 100, and
90-120), so each sweep runs ~110 steps rather than ~700.  Any failed
check raises; nothing needs preparing in a fresh process.

    python -m slb2d_tpu_torch.dryrun [n] [device=cpu|cuda:k]
"""

from __future__ import annotations

import io
import sys
import time

import numpy as np
import torch

from .config import SimConfig
from .models.superlattice import SuperlatticeModel
from .ops import stencil
from .parallel.mesh import default_split, make_mesh

# av and the table of a layout against one device: the same arithmetic
# but for the order of the sums over m.  In f32 the v_y sums cancel to
# ~1e-3 from terms of up to ~1, so a reordered sum of 128 of them moves by
# 1e-7 to 1e-6 (2.1e-7 on an H100 80GB HBM3 at the dryrun's shapes)
AV_TOL = {"f32": dict(rtol=1e-5, atol=2e-6), "f64": dict(rtol=1e-12,
                                                         atol=1e-15)}
# a kernel against the batched engine (tests/test_torch_sweep.py's TOL)
SWEEP_TOL = dict(rtol=2e-4, atol=2e-5)
STATE_FIELDS = ("a", "b", "a_hs", "b_hs", "hs_edge_a", "hs_edge_b", "t",
                "step")
PHYS = dict(display=4, E_dc=1.0, E_omega=2.0, omega=1.0, mu=1.0,
            alpha=0.9495, phi_y_min=-10.0, phi_y_max=10.0, B=0.1, dt=1e-3,
            quiet=True)


def dryrun_device(device=None) -> torch.device:
    """The device the checks run on: `device` when given (a CUDA device
    torch cannot see raises), else cuda:0 where torch sees a card and the
    CPU where it sees none: like the JAX dryrun, this one runs wherever it
    is started, and it names the device in its OK line."""
    if device is None:
        device = "cuda:0" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda" and not (
            torch.cuda.is_available()
            and (device.index or 0) < torch.cuda.device_count()):
        raise RuntimeError(f"{device}: no such CUDA device")
    return device


def _build(N, M, t_start=10.0, **over):
    cfg = SimConfig(n_harmonics=N, g_grid=M, t_start=t_start,
                    **{**PHYS, **over})
    return cfg, SuperlatticeModel(cfg)


def entry(device=None):
    """(fn, example_args): one full step of the flagship model, fn(state)
    -> state (trig from the carried t, av gated on the device)."""
    cfg, model = _build(N=100, M=4000)
    c = stencil.consts_from_model(model, dryrun_device(device))
    state = stencil.bootstrap_state(c, model)

    def fn(st):
        return stencil.fast_step(c, st, av_enabled=True)

    return fn, (state,)


def _same_state(got, ref, what, dtype, fields=STATE_FIELDS):
    """got and ref (States) bit for bit in `fields`, av at AV_TOL; returns
    av's largest absolute difference."""
    for f in fields:
        g, r = getattr(got, f).cpu(), getattr(ref, f).cpu()
        if not torch.equal(g, r):
            raise AssertionError(f"dryrun {what}: {f} not bit for bit")
    return _close(got.av, ref.av, f"{what} av", **AV_TOL[dtype])


def _close(got, ref, what, rtol, atol):
    g = np.asarray(torch.as_tensor(got).cpu(), np.float64)
    r = np.asarray(torch.as_tensor(ref).cpu(), np.float64)
    if g.shape != r.shape or not np.all(np.isfinite(g)):
        raise AssertionError(f"dryrun {what}: shape {g.shape} vs {r.shape} "
                             f"or not finite")
    np.testing.assert_allclose(g, r, rtol=rtol, atol=atol,
                               err_msg=f"dryrun {what}")
    return float(np.max(np.abs(g - r))) if g.size else 0.0


def _table_close(res, ref, what, tol):
    return max(_close(res[k], ref[k], f"{what} {k}", **tol) for k in ref)


def _launches():
    """The kernels' launch counts this dryrun reads (checks 4-6)."""
    from . import tracing
    return dict(b2_sharded_tiles=tracing.counted("launches.B2.sharded_tiles"),
                b2_sharded_replays=tracing.counted(
                    "launches.B2.sharded_replays"),
                b3_shared=tracing.counted("launches.B3.shared"),
                b3_omega=tracing.counted("launches.B3.omega"))


def _expect_launches(before, want, what, on_card):
    """Raise unless the launches since `before` are `want` on a card, none
    on the CPU (where the runners run the plain versions)."""
    now = _launches()
    got = {k: now[k] - before[k] for k in now}
    want = {k: (want.get(k, 0) if on_card else 0) for k in now}
    if got != want:
        raise AssertionError(f"dryrun {what}: launches {got}, expected "
                             f"{want}")


def _with_kernel_engine(sweep, on_card):
    """sweep's blocks on B3: on a card impl=cuda picked it; on the CPU the
    stack runner is asked for by hand, and runs the kernel's plain
    version on CPU tensors."""
    if not on_card:
        for _, sub in sweep.blocks:
            sub.engine = "cuda"
        sweep.engine = "cuda"
    return sweep


def dryrun_multichip(n_devices: int = 8, device=None) -> dict:
    """The six checks over a (sweep, space) mesh of n_devices slots of
    `device` (see dryrun_device); raises on any failure, else prints one
    "dryrun_multichip OK" line and returns what it measured: the largest
    av and table differences, the launches of checks 4-6 and the wall."""
    from .ops import stepper_stream_cuda as ssc
    from .ops.stepper_cuda import pack_xs_dict
    from .parallel.spatial import SpaceLayout
    from .parallel.stream_shard import ShardedStreamRunner
    from .parallel.sweep import ParameterSweep, _sweep_step
    from .runtime import schedule
    from .runtime.loop import Simulation

    t_wall = time.perf_counter()
    dev = dryrun_device(device)
    on_card = dev.type == "cuda"
    sweep_n, space_n = default_split(n_devices)
    slots = [dev] * n_devices
    mesh = make_mesh((sweep_n, space_n), ("sweep", "space"), devices=slots)
    cfg, model = _build(N=6, M=29, t_start=0.05, impl="torch",
                        device="cpu" if not on_card else dev.index or 0)
    dtype, D = cfg.dtype, model.np_dtype
    B = 2 * sweep_n                       # two points per sweep slot
    e_dcs = np.linspace(0.5, 2.0, B).astype(D)
    err = {}

    # 1) one combined step against the one-device step
    params = {"E_dc": e_dcs}
    comb = ParameterSweep(cfg, params, mesh=mesh, space_axis="space")
    one = ParameterSweep(cfg, params, device=dev)
    ref, _ = _sweep_step(one.consts, one._initial_states(), one._zero_cap(),
                         one._weights())
    live = []
    for _, sub in comb.blocks:
        st, cp = _sweep_step(sub.consts, sub._initial_states(),
                             sub._zero_cap(), sub._weights(), **sub._hooks())
        live.append([st, cp, None])
    got, _ = comb._whole(live)
    if got.a.shape != (B, model.NHP, model.MP) or got.av.shape != (B, 8):
        raise AssertionError(f"dryrun step: shapes {tuple(got.a.shape)}, "
                             f"{tuple(got.av.shape)}")
    err["step"] = _same_state(got, ref, "combined step", dtype)

    # 2) the sharded driver over one exact-schedule chunk
    mesh_s = make_mesh((space_n,), ("space",), devices=[dev] * space_n)
    chunk = next(iter(schedule.iter_chunks(
        omega=model.omega, dt=model.dt, t0=0.0, t_max=0.02,
        t_start=cfg.t_start, E_omega=model.E_omega, display=4,
        frame_start=0.0, T=model.T, dtype=D, chunk_max=64)))
    sim = Simulation(cfg.replace(shards=space_n), out=io.StringIO(),
                     mesh=mesh_s)
    plain = Simulation(cfg, out=io.StringIO(), device=dev)
    st2, _ = sim._run_chunk(sim.state, chunk, 0)
    st2 = sim.layout.gather_state(st2)
    ref2, _ = plain._run_chunk(plain.state, chunk, 0)
    err["driver"] = _same_state(st2, ref2, "sharded driver chunk", dtype)
    a2 = st2.a.cpu().numpy()
    norm = float(np.dot(a2[0], model.w_norm)
                 * D(2 * np.pi * np.sqrt(float(model.alpha))))

    # 3) the combined-mesh ParameterSweep against the one-device sweep
    cfg2 = cfg.replace(omega=100.0)
    comb3 = ParameterSweep(cfg2, params, mesh=mesh, space_axis="space",
                           capture_state=True)
    res3 = comb3.run()
    one3 = ParameterSweep(cfg2, params, device=dev, capture_state=True)
    ref3 = one3.run()
    for x, y in zip(comb3.final_ab, one3.final_ab):
        if not np.array_equal(x, y):
            raise AssertionError("dryrun combined sweep: captured state "
                                 "not bit for bit")
    err["sweep"] = _table_close(res3, ref3, "combined sweep", AV_TOL[dtype])

    # 4) B2's sharded form over the space slots
    cfg4, model4 = _build(N=6, M=128 * space_n - 3, t_start=0.05)
    chunk4 = next(iter(schedule.iter_chunks(
        omega=model4.omega, dt=model4.dt, t0=0.0, t_max=0.02,
        t_start=cfg4.t_start, E_omega=model4.E_omega, display=4,
        frame_start=0.0, T=model4.T, dtype=D, chunk_max=24)))
    lay = SpaceLayout(mesh_s, model4.MP)
    cs = lay.scatter_consts(stencil.consts_from_model(model4, "cpu"))
    runner = ShardedStreamRunner(cs, model4, lay, K=8)
    first = before = _launches()
    st4 = runner.run_xs(lay.bootstrap_state(cs, model4), chunk4.xs, 0)
    rounds = -(-chunk4.n_steps // 8)
    _expect_launches(before, dict(
        b2_sharded_tiles=rounds * space_n, b2_sharded_replays=rounds),
        "sharded stream", on_card)
    c4 = stencil.consts_from_model(model4, dev)
    geom = ssc.default_geometry(model4.NHP, model4.MP,
                                np.dtype(D).itemsize, K=8)
    ref4, _ = ssc.run_chunk_plain_stream(
        c4, stencil.bootstrap_state(c4, model4),
        pack_xs_dict(chunk4.xs, D), 0, (), geom)
    # t: the runner takes it from the schedule, the plain version keeps it
    err["stream"] = _same_state(lay.gather_state(st4), ref4,
                                "sharded stream", dtype,
                                [f for f in STATE_FIELDS if f != "t"])

    # 5) and 6) B3, shared-omega and per-omega, over a "sweep" mesh
    mesh_sw = make_mesh((sweep_n,), ("sweep",), devices=[dev] * sweep_n)
    cfg5 = cfg2.replace(impl="cuda" if on_card else "torch")
    for key, p in (("b3_shared", params),
                   ("b3_omega", {"omega": np.linspace(90.0, 120.0, B)})):
        before = _launches()
        sw = _with_kernel_engine(ParameterSweep(cfg5, p, mesh=mesh_sw),
                                 on_card)
        res = sw.run()
        _expect_launches(before, {key: sweep_n}, f"{key} sweep", on_card)
        if sw.engine != "cuda":
            raise AssertionError(f"dryrun {key}: engine {sw.engine}")
        ref = ParameterSweep(cfg2, p, device=dev).run()
        err[key] = _table_close(res, ref, f"{key} sweep", SWEEP_TOL)

    launches = {k: v - first[k] for k, v in _launches().items()}
    wall = time.perf_counter() - t_wall
    print(f"dryrun_multichip OK: mesh=({sweep_n},{space_n}) of {dev} "
          f"B={B} state={tuple(got.a.shape)}: one combined step == one "
          f"device (state bit for bit, av {err['step']:.3e}); sharded "
          f"driver {chunk.n_steps} steps == unsharded (norm {norm:.9f}); "
          f"combined-mesh ParameterSweep {comb3.n_steps} steps (captures "
          f"bit for bit, table {err['sweep']:.3e}); B2 sharded "
          f"{chunk4.n_steps} steps over {space_n} shards == unsharded "
          f"tiling; B3 over {sweep_n} sweep slots (table "
          f"{err['b3_shared']:.3e}); B3 per-omega (table "
          f"{err['b3_omega']:.3e}); launches {launches}; {wall:.2f} s",
          flush=True)
    return dict(mesh=(sweep_n, space_n), device=str(dev), max_abs_err=err,
                launches=launches, wall_s=wall)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    n, device = 8, None
    for tok in argv:
        if tok.startswith("device="):
            device = tok[len("device="):]
            device = device if not device.isdigit() else f"cuda:{device}"
        else:
            n = int(tok)
    dryrun_multichip(n, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
