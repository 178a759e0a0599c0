"""One run of one cell: set-up, the timed window, the traced pass, the check.

Everything a cell needs is found by name from ``BENCHMARK.json``: its
configuration file (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``), the limits of its comparison
(``checks/<cell>.json``) and one reader per per-layer metric
(``metrics/<metric>.py``). The configuration file names its plain reference
(``reference/<reference>.py``), which refuses a configuration it does not
model. A later cell, mix, metric or reference is new files and entries;
nothing here names one.

Set-up (``setup_s``): load the scene, jitter the fluid lattice from the seed,
``Simulation`` (prepare, the warm-up step, the capture), the captured step
run up to the mix's start time with no host read, a snapshot of that state
on the device, one warm replay. The window then drives the driver's loop
(``cli.py`` ``main`` with export off): each step one ``Simulation.step()``
and one host read of its diagnostics, which synchronises; every
``segment_steps`` steps the snapshot is written back through the
``Simulation.state`` setter, so the window replays one fixed segment of the
trajectory. The state after the first step of the first segment is copied
aside and, once the window has closed and the simulation is freed, held to
the plain reference's step from the snapshot (``check.py``). Where the
snapshot holds a present dynamic body, the copy also keeps every row's
object id and each body's ``com``, ``rot``, ``vel`` and ``omega``, and the
bodies' state after each segment's first step is held to the first
segment's (``segment_breaks``); without one the window holds and allocates
nothing more.

The reference module ``reference/<name>.py`` provides

- ``physics_of(config) -> ph``: the constants of a configuration file, an
  object with at least ``rho0``, ``max_iter``, ``max_iter_v``,
  ``viscosity_method``, ``diameter``, ``h``, ``domain_start`` and
  ``grid_num`` (``check.cell_ids`` bins by the last three); it raises
  ``ValueError`` on a configuration it does not model;
- ``step(start, ph, dtype) -> dict``: one step from the snapshot, computed in
  ``dtype`` (float64; the control passes a lower precision);
- ``Pairs(x, active, ph)``: the pairs within the support radius, with ``i``,
  ``j`` and ``d2`` (the pair counts of the roofline readers);
- ``FLUID`` and ``RIGID``: the material codes.

``start`` holds every tensor of the snapshot by name: the particle fields
(``pos``, ``vel``, ``material``, ``object_id``, ``is_dynamic``,
``rigid_rest_pos``, ``rest_volume``, ``mass``, ``density`` and the rest of
``ParticleState``), the state's own (``t``, ``step_count`` and what the
program carries between steps, such as ``dfsph_alpha``) and the bodies'
``RigidState`` fields under ``start["rigid"]``. A reference reads what it
models and works the rest out again (``reference/sph.py`` reads ``pos``,
``vel`` and ``material``). It returns, as float tensors of any row order,
``pos``, ``vel``, ``density``, ``rest_volume``, ``mass`` and ``material``;
it may return ``alpha``, the iteration counts of ``check.ITERS`` and
``cg_iters``, and, for a configuration with moving bodies, each row's
``object_id`` and ``bodies``: ``{object id: {"com", "rot", "vel",
"omega"}}`` of the present dynamic bodies. ``check.compare`` compares what
it returns and nothing else.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import os
import statistics
import sys
import time

import torch

import bench_trace
import check

HERE = os.path.dirname(os.path.abspath(__file__))
# device operations one profiler session may hold
SESSION_EVENTS = 40_000
# the least share of the program's pair launches a trace must hold
COVERAGE = 0.99
FOREIGN = ("jax", "jaxlib", "flax", "sph_project_tpu")
MANIFEST = "BENCHMARK.json"


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(root: str, name: str, bench_dir: str = HERE) -> dict:
    """The cell ``name`` of ``root``'s manifest with its configuration,
    traffic mix, limits and per-layer metrics, each found by name."""
    man = read_json(os.path.join(root, MANIFEST))
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {MANIFEST}")
    cell = cells[name]
    configs = {c["name"]: c for c in man["configs"]}
    entry = configs[cell["config"]]
    config = read_json(os.path.join(root, entry["file"]))
    traffic = read_json(os.path.join(bench_dir, "traffic",
                                     f"{cell['traffic']}.json"))
    limits = read_json(os.path.join(bench_dir, "checks", f"{name}.json"))
    e2e = [m for m in man["end_to_end"]
           if name in m.get("workloads", [name])]
    layer = [m for m in man["per_layer"]
             if name in m.get("workloads", [name])]
    return dict(cell=cell, config=config, traffic=traffic,
                limits=limits["limits"], end_to_end=e2e, per_layer=layer,
                bench_dir=bench_dir)


def reference_of(config: dict, bench_dir: str = HERE):
    """The module ``reference/<name>.py`` of ``bench_dir`` that the
    configuration names: ``reference.<name>`` where that is this file (as
    ``check.py`` imports it), else loaded from the file under a name of its
    own."""
    name = f"reference.{config['reference']}"
    path = os.path.join(bench_dir, "reference", f"{config['reference']}.py")
    mod = sys.modules.get(name)
    if mod is not None:
        if os.path.samefile(mod.__file__, path):
            return mod
        name = f"{name}@{os.path.abspath(path)}"
        if name in sys.modules:
            return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def metric_reader(bench_dir: str, name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def foreign_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FOREIGN})


def clone_tree(tree):
    """A copy of a state whose every tensor is a buffer of its own."""
    out = {}
    for f in dataclasses.fields(tree):
        v = getattr(tree, f.name)
        if torch.is_tensor(v):
            v = v.clone()
        elif dataclasses.is_dataclass(v):
            v = clone_tree(v)
        out[f.name] = v
    return dataclasses.replace(tree, **out)


# the body fields a window holds and the comparison reads
BODY_FIELDS = ("com", "rot", "vel", "omega")


def held_fields(state, bodies: bool = False) -> dict:
    """The fields of a state that the comparison reads, copied; with
    ``bodies`` also the rows' object ids and the body table (``rigid``:
    :data:`BODY_FIELDS` and what says which bodies are present and
    dynamic)."""
    p = state.particles
    out = dict(pos=p.pos.clone(), vel=p.vel.clone(),
               density=p.density.clone(), rest_volume=p.rest_volume.clone(),
               mass=p.mass.clone(), material=p.material.clone(),
               alpha=state.dfsph_alpha.clone())
    if bodies:
        r = state.rigid
        out["object_id"] = p.object_id.clone()
        out["rigid"] = {k: getattr(r, k).clone() for k in
                        BODY_FIELDS + ("is_dynamic", "present",
                                       "obj_material")}
    return out


def present_bodies(rigid: dict) -> torch.Tensor:
    """(objects,) the bodies of a body table (a dict of ``RigidState``
    fields) that move: dynamic, present and rigid."""
    from sph_project_tpu_torch.core.params import MATERIAL_RIGID
    return (rigid["is_dynamic"] > 0) & (rigid["present"] > 0) & \
        (rigid["obj_material"] == MATERIAL_RIGID)


def bodies_of(rigid: dict) -> dict:
    """``{object id: {field: value}}`` of the present dynamic bodies of a
    body table."""
    ids = torch.nonzero(present_bodies(rigid)).flatten().tolist()
    return {i: {k: rigid[k][i] for k in BODY_FIELDS} for i in ids}


def body_state(rigid) -> torch.Tensor:
    """Every body's :data:`BODY_FIELDS` in one flat tensor."""
    return torch.cat([getattr(rigid, k).flatten() for k in BODY_FIELDS])


def jitter(state, seed: int, amplitude: float, device):
    """The fluid rows moved by up to ``amplitude`` along each axis, drawn
    on the device from ``seed``."""
    from sph_project_tpu_torch.core.params import MATERIAL_FLUID
    state = state.to(device)
    p = state.particles
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    u = torch.rand(p.pos.shape, generator=gen, device=device)
    fluid = (p.material == MATERIAL_FLUID)[:, None]
    pos = torch.where(fluid, p.pos + (2.0 * u - 1.0) * amplitude, p.pos)
    return state.replace(particles=p.replace(pos=pos))


def _null():
    return contextlib.nullcontext()


def iters_of(vals: dict, cg) -> tuple:
    return tuple(int(vals.get(k, 0)) for k in check.ITERS) + \
        (() if cg is None else (int(cg),))


def gather_words(state, params) -> int:
    """32-bit words a row that the sort's gather moves: the fields the
    program carries across the sort, as the state holds them, and the cell
    id."""
    from sph_project_tpu_torch.sim import permuted_keys
    keys, extras = permuted_keys(params)
    p = state.particles
    fields = [getattr(p, k) for k in keys] + [getattr(state, k)
                                              for k in extras]
    return 1 + sum(t[0].numel() * t.element_size() // 4 for t in fields)


def p95(values: list) -> float:
    return statistics.quantiles(values, n=20, method="inclusive")[18]


class Cell:
    """One run of a cell on ``device``. ``wrap``, when given, wraps the
    simulation after set-up (the harness's tests break the step with it)."""

    def __init__(self, spec: dict, seed: int, device: str = "cuda",
                 wrap=None):
        self.spec = spec
        self.seed = seed
        self.device = torch.device(device)
        self.wrap = wrap
        cfg = spec["config"]
        self.ref_mod = reference_of(cfg, spec["bench_dir"])
        self.ph = self.ref_mod.physics_of(cfg)
        self.gates = dict(cfg["gates"], rho0=self.ph.rho0,
                          max_iter=self.ph.max_iter,
                          max_iter_v=self.ph.max_iter_v)
        self.implicit = self.ph.viscosity_method == "implicit"
        self.timings: dict = {}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _cg(self):
        from sph_project_tpu_torch.solvers import viscosity_cg
        return viscosity_cg.last_solve["cg_iters"] if self.implicit else None

    def setup(self, t0: float, traced: bool) -> None:
        from sph_project_tpu_torch.scene import load_scene
        from sph_project_tpu_torch.sim import Simulation
        from sph_project_tpu_torch.utils.config import SimConfig
        from sph_project_tpu_torch.utils.telemetry import host_values
        cfg, tr = self.spec["config"], self.spec["traffic"]
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
            if traced:
                bench_trace.attach_profiler()
        t = time.perf_counter()
        scene, state = load_scene(config=SimConfig(config=cfg["scene"]),
                                  **cfg["constants"], **cfg["overrides"])
        amp = tr["jitter_spacing"] * scene.params.particle_spacing
        state = jitter(state, self.seed, amp, self.device)
        self.input_pos = state.particles.pos.clone()
        self.input_mat = state.particles.material.clone()
        self._sync()
        self.params = scene.params
        self.timings["load_s"] = time.perf_counter() - t
        t = time.perf_counter()
        sim = Simulation(scene, state, device=self.device)
        self._sync()
        self.timings["simulation_s"] = time.perf_counter() - t
        self.timings["warmup_s"] = sim.warmup_ms / 1e3
        self.timings["capture_s"] = sim.capture_ms / 1e3
        t = time.perf_counter()
        n_settle = int(round(tr["start_s"] / scene.params.dt))
        self.settle_failed = 0
        fluid0 = None
        done = 0
        while done < n_settle:
            k = min(250, n_settle - done)
            d = sim.run(k)
            stacked = {key: v.double().cpu() for key, v in d.items()}
            for i in range(k):
                vals = {key: float(v[i]) for key, v in stacked.items()}
                if fluid0 is None:
                    fluid0 = vals["fluid_num"]
                self.settle_failed += check.gate_failures(vals, self.gates,
                                                          fluid0)
            done += k
        self._sync()
        self.timings["settle_s"] = time.perf_counter() - t
        self.settle_steps = n_settle
        t = time.perf_counter()
        self.snapshot = clone_tree(sim.state)
        # one warm replay of what the window does: restore, step, read
        sim.state = self.snapshot
        host_values(sim.step())
        sim.state = self.snapshot
        self._sync()
        self.timings["snapshot_s"] = time.perf_counter() - t
        self.sim = self.wrap(sim) if self.wrap else sim
        self.fluid0 = int((self.snapshot.particles.material == 1).sum())
        self.bodies = self.params.has_dynamic_rigid and bool(
            present_bodies(self.start_state()["rigid"]).any())
        self.setup_s = time.perf_counter() - t0

    def window(self, seconds: float) -> None:
        """The timed window: whole steps until ``seconds`` have passed."""
        from sph_project_tpu_torch.utils.telemetry import host_values
        seg = self.spec["traffic"]["segment_steps"]
        sim = self.sim
        cg_buf = torch.zeros(seg, dtype=torch.int32, device=self.device) \
            if self.implicit else None
        first, pass_rows, body_firsts = [], [], []
        self.segment_breaks = 0
        self.failed = 0
        times = []
        k = 0
        segments = 0
        t_start = time.perf_counter()
        t_prev = t_start
        while True:
            if k == seg:
                self._segment_done(first, pass_rows, cg_buf, segments)
                sim.state = self.snapshot
                k = 0
                segments += 1
                pass_rows = []
            diag = sim.step()
            if cg_buf is not None:
                cg_buf[k].copy_(self._cg())
            vals = host_values(diag)
            now = time.perf_counter()
            times.append(now - t_prev)
            t_prev = now
            if segments == 0 and k == 0:
                self.held = held_fields(sim.state, self.bodies)
                self.held_vals = vals
            if self.bodies and k == 0:
                body_firsts.append(body_state(sim.state.rigid))
            pass_rows.append(vals)
            self.failed += check.gate_failures(vals, self.gates, self.fluid0)
            k += 1
            if now - t_start >= seconds:
                break
        self.window_s = t_prev - t_start
        self._segment_done(first, pass_rows, cg_buf, segments)
        # a later segment whose bodies left its first step otherwise than
        # the first segment's did
        self.segment_breaks += sum(not torch.equal(b, body_firsts[0])
                                   for b in body_firsts[1:])
        self.held_cg = int(first[0][2]) if self.implicit else None
        self.steps = len(times)
        self.step_times = times
        self.segments = segments + k / seg

    def _segment_done(self, first, rows, cg_buf, segments):
        """Keep the first pass's iteration counts; count the steps of a
        later pass whose counts differ from the first's."""
        n = len(rows)
        cg = cg_buf[:n].tolist() if cg_buf is not None else [None] * n
        its = [iters_of(v, c) for v, c in zip(rows, cg)]
        if segments == 0:
            first.extend(its)
            return
        self.segment_breaks += sum(a != b for a, b in zip(its, first))

    def traced_pass(self) -> dict:
        """One segment replayed from the snapshot without the profiler (its
        wall), then again under ``torch.profiler``, with the benchmark's own
        spans around each call into the program. The profiled replay runs
        in sessions of a few steps, each holding at most
        :data:`SESSION_EVENTS` device operations, so that no session's
        record buffers fill; the trace is then held to the program's launch
        counters (:data:`COVERAGE`)."""
        from torch.profiler import ProfilerActivity, profile, record_function

        from sph_project_tpu_torch.utils.telemetry import host_values
        seg = self.spec["traffic"]["segment_steps"]
        sim = self.sim
        cg_buf = torch.zeros(seg, dtype=torch.int32, device=self.device) \
            if self.implicit else None

        def step(k, rows, spans):
            with record_function("bench.replay") if spans else _null():
                diag = sim.step()
            with record_function("bench.read") if spans else _null():
                if cg_buf is not None:
                    cg_buf[k].copy_(self._cg())
                rows.append(host_values(diag))

        sim.state = self.snapshot
        self._sync()
        rows = []
        t0 = time.perf_counter()
        for k in range(seg):
            step(k, rows, False)
        wall_s = time.perf_counter() - t0
        sim.state = self.snapshot
        self._sync()
        counted = launch_counts()
        prof_rows, dev, spans, gaps = [], [], [], []
        window_ns = busy_ns = 0.0
        k, chunk = 0, 2
        t0 = time.perf_counter()
        while k < seg:
            n = min(chunk, seg - k)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                with record_function("bench.session"):
                    for i in range(k, k + n):
                        step(i, prof_rows, True)
            d, sp = bench_trace.device_events(prof)
            ses = [x for x in sp if x[0] == "bench.session"][0]
            lo, hi = ses[1], ses[2]
            d = [x for x in d if x[2] > lo and x[1] < hi]
            sp = [x for x in sp if x[0] != "bench.session"]
            window_ns += hi - lo
            busy_ns += bench_trace.union_ns([(a, b) for _, a, b in d])
            gaps += bench_trace.idle_gaps(d, sp, lo, hi)
            dev += d
            spans += sp
            k += n
            chunk = max(1, min(seg, SESSION_EVENTS * n // max(len(d), 1)))
        prof_wall_s = time.perf_counter() - t0
        after = launch_counts()
        counted = {k: after[k] - counted.get(k, 0) for k in after
                   if after[k] != counted.get(k, 0)}
        cg = cg_buf.tolist() if cg_buf is not None else None
        fam = bench_trace.Families(os.path.join(self.spec["bench_dir"],
                                          "families.json"))
        traced: dict = {}
        for name, _, _ in dev:
            body = fam.body(name)
            if body:
                traced[body] = traced.get(body, 0) + 1
        # the profiler can lose a WHILE body's kernels (the viscous
        # column's trace held about half of its CG's): the device-time
        # readers read only a trace that holds the pair launches the
        # program counted, to within COVERAGE
        complete = all(traced.get(b, 0) >= COVERAGE * n
                       for b, n in counted.items())
        gaps.sort(key=lambda x: -x[1])
        return dict(steps=seg, wall_s=wall_s, profiled_wall_s=prof_wall_s,
                    window_s=window_ns / 1e9, busy_s=busy_ns / 1e9,
                    kernels=dev if complete else [], all_kernels=dev,
                    gaps=gaps, families=fam, complete=complete,
                    launches={"counted": counted, "traced": traced},
                    diags=rows, cg_iters=cg,
                    same_iters=[iters_of(a, None) for a in rows] ==
                    [iters_of(a, None) for a in prof_rows],
                    gather_words=gather_words(self.snapshot, self.params))

    def free(self) -> None:
        """Drop the simulation, so that the reference runs in the memory
        the program held."""
        self.sim = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def start_state(self) -> dict:
        """Every tensor of the snapshot by name (the module docstring), not
        copied."""
        s = self.snapshot
        out = {f.name: getattr(s.particles, f.name)
               for f in dataclasses.fields(s.particles)}
        out.update({f.name: getattr(s, f.name) for f in dataclasses.fields(s)
                    if torch.is_tensor(getattr(s, f.name))})
        out["rigid"] = {f.name: getattr(s.rigid, f.name)
                        for f in dataclasses.fields(s.rigid)}
        return out

    def reference(self) -> dict:
        """The reference's step from the snapshot (computed once)."""
        if getattr(self, "_ref", None) is None:
            s0 = self.start_state()
            t = time.perf_counter()
            self._ref = self.ref_mod.step(s0, self.ph)
            self.timings["reference_s"] = time.perf_counter() - t
        return self._ref

    def reference_check(self) -> dict:
        """The compared numbers: the held step against the reference's
        step from the snapshot; the start against the benchmark's input
        where the segment starts at step 0; the gates of the settle; the
        segments' repeat."""
        s0 = self.start_state()
        ref = self.reference()
        out = dict(self.held, **{k: int(self.held_vals[k])
                                 for k in check.ITERS
                                 if k in self.held_vals})
        if self.implicit:
            out["cg_iters"] = self.held_cg
        if "rigid" in out:
            out["bodies"] = bodies_of(out.pop("rigid"))
        nums = check.compare(out, ref, self.ph)
        nums["segment_breaks"] = self.segment_breaks
        nums["settle_failed"] = self.settle_failed
        nums["failed"] = self.failed
        if self.settle_steps == 0:
            nums["start_breaks"] = start_breaks(
                self.input_pos, self.input_mat, s0["pos"], s0["material"])
        self.ref_iters = tuple(ref.get(k) for k in check.ITERS
                               + ("cg_iters",))
        return nums

    def pair_work(self) -> dict:
        """The work of the snapshot's pair passes, counted by the
        reference's neighbour search: pairs inside the radius of the rows
        that produce (fluid rows and the rows of present dynamic bodies;
        all, and with a rigid neighbour) and the rows such a pass reads;
        of the dynamic rows alone (the bodies' own passes) their pairs,
        those within one object, those touching another object (a rigid
        neighbour of another object closer than a particle diameter) and
        the rows they read; the rows and the grid's cells."""
        s0 = self.start_state()
        mat = s0["material"]
        ref = self.ref_mod
        pr = ref.Pairs(s0["pos"].double(), mat != 0, self.ph)
        obj = s0["object_id"]
        body = present_bodies(s0["rigid"])
        dyn = (mat == ref.RIGID) & (s0["is_dynamic"] > 0) & (obj >= 0) & \
            body[obj.clamp(0, body.numel() - 1).long()]
        prod = (mat == ref.FLUID) | dyn

        def rows_read(rows, sel):
            near = torch.zeros_like(mat, dtype=torch.bool)
            near[pr.j[sel]] = True
            return int((rows | near).sum())

        fi = prod[pr.i]
        di = dyn[pr.i]
        other = (mat[pr.j] == ref.RIGID) & (obj[pr.j] != obj[pr.i]) & \
            (obj[pr.j] >= 0)
        return dict(pairs=int(fi.sum()),
                    wall_pairs=int((fi & (mat[pr.j] == ref.RIGID)).sum()),
                    rows_read=rows_read(prod, fi), n=int(mat.numel()),
                    cells=math.prod(self.ph.grid_num),
                    dyn_pairs=int(di.sum()),
                    same_pairs=int((di & (obj[pr.j] == obj[pr.i])).sum()),
                    touch_pairs=int((di & other & (pr.d2 < self.ph.diameter
                                                   ** 2)).sum()),
                    dyn_rows_read=rows_read(dyn, di))


def launch_counts() -> dict:
    """The program's pair-kernel launch counters by body, every replay's
    loop iterations included (one synchronisation)."""
    from sph_project_tpu_torch.ops import graph_loop, pair_kernels
    graph_loop.flush_launches()
    out: dict = {}
    for key, n in pair_kernels.launches.items():
        name = key.split("/")[1]
        body = name.split("@")[0].split("+")[0] + \
            ("+rigid" if name.endswith("+rigid") else "")
        out[body] = out.get(body, 0) + n
    return out


def start_breaks(in_pos, in_mat, pos, mat) -> int:
    """Rows of the prepared state that are not the benchmark's input rows,
    permuted: the count of rows of either side without an equal partner."""
    def keyed(x, m):
        act = m != 0
        rows = torch.cat([x[act].double(), m[act, None].double()], 1)
        for c in range(rows.shape[1] - 1, -1, -1):
            rows = rows[torch.sort(rows[:, c], stable=True).indices]
        return rows
    a, b = keyed(in_pos, in_mat), keyed(pos, mat)
    if a.shape != b.shape:
        return abs(a.shape[0] - b.shape[0]) + min(a.shape[0], b.shape[0])
    return int((a != b).any(1).sum())


def device_info(device) -> dict:
    if device.type != "cuda":
        return dict(platform="cpu", kind="cpu", count=1, memory_peak_bytes=0)
    return dict(platform="gpu", kind=torch.cuda.get_device_name(device),
                count=1,
                memory_peak_bytes=int(torch.cuda.max_memory_allocated(device)))


def judged(nums: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {value, limit}}) over the numbers the cell's limits
    name: every one finite and at or under its limit. A limit whose number
    was not computed fails."""
    checks = {}
    ok = True
    for k, lim in limits.items():
        v = nums.get(k, math.nan)
        ok &= math.isfinite(v) and v <= lim
        checks[k] = {"value": v, "limit": lim}
    return ok, checks


def run_cell(root: str, name: str, seed: int, seconds: float, traced: bool,
             t0: float, device: str = "cuda", wrap=None,
             bench_dir: str = HERE) -> dict:
    """One run of cell ``name``; returns the result line's object."""
    spec = load_cell(root, name, bench_dir)
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = Cell(spec, seed, device, wrap)
    cell.setup(t0, traced)
    log(f"set-up {cell.setup_s:.3f} s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in cell.timings.items())
        + f"; settle {cell.settle_steps} steps")
    cell.window(seconds)
    steps = cell.steps
    log(f"window {cell.window_s:.3f} s: {steps} steps, "
        f"{cell.segments:.2f} segments of "
        f"{spec['traffic']['segment_steps']}; segment repeats broke "
        f"{cell.segment_breaks} steps; the first step's iterations "
        f"{iters_of(cell.held_vals, cell.held_cg)}")
    e2e = {
        "step_ms": (cell.window_s / steps * 1e3, "ms"),
        "step_p95_ms": (p95([t * 1e3 for t in cell.step_times])
                        if steps > 1 else cell.step_times[0] * 1e3, "ms"),
        "mem_gib": (torch.cuda.max_memory_allocated(cell.device) / 2 ** 30
                    if cell.device.type == "cuda" else math.nan, "GiB"),
        "setup_s": (cell.setup_s, "s"),
    }
    dev = device_info(cell.device)
    rec = cell.traced_pass() if traced else None
    cell.free()
    nums = cell.reference_check()
    log(f"reference {cell.timings['reference_s']:.3f} s; its iterations "
        f"{cell.ref_iters}")
    metrics, breakdown = {}, None
    if traced:
        rec["work"] = cell.pair_work()
        for m in spec["per_layer"]:
            v = metric_reader(spec["bench_dir"], m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev.update(busy_s=rec["busy_s"], window_s=rec["window_s"])
        breakdown = breakdown_of(rec)
        log(f"traced segment: {rec['steps']} steps, wall "
            f"{rec['wall_s']:.4f} s unprofiled, {rec['profiled_wall_s']:.4f}"
            f" s profiled; busy {rec['busy_s']:.4f} s; "
            f"{len(rec['all_kernels'])} device operations; iterations the same "
            f"in both: {rec['same_iters']}; pair launches counted by the "
            f"program {rec['launches']['counted']}, in the trace "
            f"{rec['launches']['traced']}: the trace is "
            f"{'complete' if rec['complete'] else 'incomplete'}")
    else:
        for m in spec["end_to_end"]:
            v, unit = e2e[m["name"]]
            metrics[m["name"]] = {"value": v, "unit": unit}
    correct, checks = judged(nums, spec["limits"])
    for k, c in checks.items():
        log(f"check {k}: {c['value']} (limit {c['limit']})")
    out = {"correct": correct, "attempted": steps, "failed": cell.failed,
           "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


def breakdown_of(rec: dict) -> dict:
    """The device operations that took most time, by family, and the
    longest idle gaps, by the benchmark's span the host was in."""
    fam = rec["families"]
    by: dict = {}
    for name, s, e in rec["all_kernels"]:
        f = fam(name)
        by[f] = by.get(f, 0.0) + (e - s) / 1e9
    ops = sorted(by.items(), key=lambda x: -x[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in rec["gaps"][:10]]}
