"""One run of one cell: set-up, warm-up, the measured window, the check.

`run_cell` is what vobench/run.py calls once it has found a CUDA device;
the tests call it on the CPU at small sizes (`overrides`), with a fault
planted in the timed path (`fault`), or with the control in the
program's place (`program=False`).
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import json
import subprocess
import sys
import time
from copy import deepcopy
from pathlib import Path

import numpy as np

from vobench.harness import spec, traffic as traffic_gen
from vobench.harness.judge import Capture, Plan

FORBIDDEN = ("jax", "jaxlib", "flax", "visualodometry_tpu")
FAULTS = ("frozen_state", "half_batch", "altered_answer", "unobserved_step", "unobserved_k1")


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _merge(base: dict, over: dict) -> dict:
    out = deepcopy(base)
    for k, v in (over or {}).items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def umeyama_sim3_ate(est: np.ndarray, gt: np.ndarray) -> float:
    """RMSE after the closed-form similarity alignment of est to gt (copy
    of the port's eval/ate.py `ate_rmse(..., align="sim3")`)."""
    est, gt = np.asarray(est, np.float64), np.asarray(gt, np.float64)
    mu_s, mu_d = est.mean(0), gt.mean(0)
    xs, xd = est - mu_s, gt - mu_d
    n = len(est)
    U, S, Vt = np.linalg.svd(xd.T @ xs / n)
    D = np.eye(3)
    D[-1, -1] = np.sign(np.linalg.det(U) * np.linalg.det(Vt))
    R = U @ D @ Vt
    s = float(np.trace(np.diag(S) @ D) / max((xs**2).sum() / n, 1e-12))
    aligned = s * est @ R.T + (mu_d - s * R @ mu_s)
    return float(np.sqrt((np.linalg.norm(aligned - gt, axis=1) ** 2).mean()))


def card_lines(torch) -> list[str]:
    """The card's name, count, power limit and sampled clocks."""
    lines = [f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}"]
    try:
        q = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,clocks.sm,clocks.max.sm,"
             "temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20,
        )
        lines.append("nvidia-smi name, power.limit, power.draw, clocks.sm, clocks.max.sm, "
                     f"temperature: {q.stdout.strip()}")
    except (OSError, subprocess.SubprocessError) as e:
        lines.append(f"nvidia-smi not read: {e}")
    return lines


class Outcomes:
    """Each (lane, drive)'s poses, resets and keyframes, on the host."""

    def __init__(self, drives, F):
        self.drives, self.F = drives, F
        self.poses, self.resets, self.keyframes = {}, {}, {}
        self.failed = 0

    def add(self, lane, drive, pos, T_wc, did_reset, is_keyframe):
        key = (lane, drive)
        P = self.poses.setdefault(key, np.full((self.F, 3), np.nan))
        n = len(T_wc)
        P[pos:pos + n] = T_wc[:, :3, 3]
        finite = np.isfinite(T_wc).all(axis=(1, 2))
        self.resets[key] = self.resets.get(key, 0) + int(did_reset.sum())
        self.keyframes[key] = self.keyframes.get(key, 0) + int(is_keyframe.sum())
        self.failed += int((~finite | did_reset.astype(bool)).sum())

    def lines(self) -> list[str]:
        out = []
        for (lane, drive), P in sorted(self.poses.items()):
            done = int(np.isfinite(P).all(axis=1).sum())
            gt = self.drives[lane].gt
            ate = None
            if done >= 16 and self.resets[(lane, drive)] == 0:
                ate = umeyama_sim3_ate(P[8:done], gt[8:done])
            out.append(json.dumps({
                "lane": lane, "drive": drive, "drive_seed": self.drives[lane].seed,
                "frames": done, "resets": self.resets[(lane, drive)],
                "keyframes": self.keyframes[(lane, drive)], "ate_sim3_m": ate,
            }))
        return out


def _read_host(torch, outs_T, flags):
    """One copy to the host: the chunk's poses and its reset and keyframe
    flags."""
    n = outs_T.shape[0]
    packed = torch.cat([outs_T.reshape(n, -1), flags.reshape(n, -1).to(outs_T.dtype)], dim=1)
    host = packed.cpu().numpy()
    return host


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             root: Path = spec.ROOT, program: bool = True, fault: str | None = None,
             overrides: dict | None = None, t_start: float | None = None,
             workers: int | None = None, until_checked: bool = False,
             ref_device: str | None = None, bench: dict | None = None) -> dict:
    """One run; `until_checked` keeps the window open until every frame the
    check reads has been handed in (the control's and the tests' runs);
    `ref_device` runs the reference elsewhere than the program, on the
    program's RANSAC draws (vobench/control.py's float-order witness);
    `bench` stands in for BENCHMARK.json (a cell added as data)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = spec.load_cell(name, root, bench)
    over = overrides or {}
    config = _merge(cell.config, over.get("config"))
    traffic = _merge(cell.traffic, over.get("traffic"))
    limits = _merge(cell.limits, over.get("limits"))
    mode, F = traffic["mode"], int(traffic["drive_frames"])
    B = int(traffic.get("lanes", 1))
    unit = 1 if mode == "online" else int(traffic["chunk"])
    if F % unit:
        raise ValueError(f"{name}: drive of {F} frames is no whole number of {unit}-frame units")
    image_size = tuple(config["vo_config"]["image_size"])

    # frames rendered in worker processes while the program is imported and built
    finish_drives = traffic_gen.start_drives(traffic, image_size, seed, workers)
    K = traffic_gen.drive_K(image_size)

    import torch

    from vobench.harness import systems
    from vobench.harness.trace import Spans, read_profile
    from vobench.reference.precision import lowered

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    superpoint = config["vo_config"]["extractor_type"] == "superpoint"
    precision = (contextlib.nullcontext() if program
                 else lowered(tf32=True, fp8=superpoint))

    plan = Plan.draw(seed, int(traffic["check"]["drives"]), int(traffic["check"]["frames"]), F)
    caps: list[Capture] = []
    batches: dict = {}
    spans = Spans(dev, enabled=False)
    stretch = {"on": False, "k1": [], "k2": [], "net_frames": 0}
    latencies: list[float] = []
    net_hook = {"want": None, "out": None}
    # the frames of the current unit that the check reads: index in the unit -> Capture
    cur = {"i": 0, "want": {}}

    def record(label):
        if stretch["on"]:
            return torch.profiler.record_function(f"vobench.{label}")
        return contextlib.nullcontext()

    # K1's outputs on the checked frames: the matcher's top-2 calls, observed
    # (one call a step; the control's lanes make one 2-D call a lane)
    k1 = {"on": False, "calls": []}
    matcher = importlib.import_module("visualodometry_tpu_torch.frontend.matcher" if program
                                      else "vobench.reference.frontend.matcher")
    top2 = matcher.match_top2

    def top2_hook(fn, d0, d1, v1):
        out = fn(d0, d1, v1)
        if k1["on"]:
            k1["calls"].append(out)
        return out

    @contextlib.contextmanager
    def k1_for(cap):
        if cap is None:
            yield
            return
        k1["on"], k1["calls"] = True, []
        try:
            yield
        finally:
            calls = k1["calls"]
            cap.k1 = (calls[0] if len(calls) == 1
                      else tuple(torch.stack(x) for x in zip(*calls)) if calls else None)
            k1["on"], k1["calls"] = False, []

    # the hooks around the program's own calls into its extractor and step
    def extract_hook(fn, imgs):
        n = 1 if mode == "online" else len(imgs)
        with spans.span("extract", n), record("extract"):
            feats = fn(imgs)
        if stretch["on"]:
            stretch["k2"].append([feats] if mode == "online" else feats)
            stretch["net_frames"] += n
        return feats

    def step_hook(fn, state, feats, *rest):
        i = cur["i"]
        cur["i"] += 1
        c = cur["want"].get(i)
        if c is not None:
            c.pre_state, c.gen_state, c.feats = state, fn.generator.get_state(), feats
            if net_hook["out"] is not None:
                c.net = (net_hook["out"][0][i], net_hook["out"][1][i])
        if stretch["on"]:
            stretch["k1"].append((state.keyframe.kp_valid, feats.valid, feats.desc.shape[-1]))
        with spans.span("step", 1), record("step"), k1_for(c):
            new, out = fn(state, feats, *rest)
        if c is not None:
            c.out, c.post_state = out, new
        return new, out

    observe = (lambda f: systems.Observed(f, extract_hook), lambda f: systems.Observed(f, step_hook))
    system = systems.build(mode, config, seed, K, dev, root, lanes=B, program=program,
                           observe=observe)
    engine = getattr(system, "engine", None)
    if engine is not None:
        engine._extract, engine._step = observe[0](engine._extract), observe[1](engine._step)
    matcher.match_top2 = systems.Observed(top2, top2_hook)
    if fault is not None:
        _plant(system, mode, fault, matcher)
    if cuda:
        for line in card_lines(torch):
            log(line)
    t_built = time.perf_counter()
    drives = finish_drives()
    frames = np.stack([d.frames for d in drives])  # (B, F, H, W) uint8
    t_frames = time.perf_counter()

    outcomes = Outcomes(drives, F)
    if system.model is not None:
        def hook(_m, _inp, out):
            if net_hook["want"] is not None:
                net_hook["out"] = tuple(o.detach() for o in out)
        system.model.register_forward_hook(hook)
    gens = system.generators

    # ---- one unit of work: a chunk (chunked, lanes) or a frame (online)
    st = {"state": None}

    def arm(drive, pos, n, check, key):
        """The unit's checked frames, as empty captures the hooks fill."""
        want = {i: Capture(drive, pos + i, 0, key, i) for i in range(n)
                if check and plan.wants(drive, pos + i)}
        cur.update(i=0, want=want)
        if want:
            net_hook["want"] = key
        return want

    def disarm(want):
        caps.extend(want.values())
        cur.update(i=0, want={})
        net_hook["want"] = net_hook["out"] = None

    def unit_chunked(g, check):
        drive, pos = divmod(g, F)
        if pos == 0:
            st["state"] = system.fresh()
        key = (drive, pos)
        imgs = frames[0, pos:pos + unit]
        want = arm(drive, pos, unit, check, key)
        if want:
            batches[key] = imgs
        st["state"], outs = system.run(st["state"], imgs)
        disarm(want)
        with record("readback"):
            flags = torch.stack([outs.did_reset, outs.is_keyframe], dim=1)
            host = _read_host(torch, outs.T_wc, flags)
        outcomes.add(0, drive, pos, host[:, :16].reshape(-1, 4, 4), host[:, 16], host[:, 17])

    def unit_lanes(g, check):
        drive, pos = divmod(g, F)
        if pos == 0:
            st["state"] = system.fresh()
        want = [i for i in range(unit) if check and plan.wants(drive, pos + i)]
        key = (drive, pos)
        block = frames[:, pos:pos + unit].reshape(B * unit, *frames.shape[2:])
        if want:
            batches[key] = block
        with record("upload"):
            x = torch.as_tensor(block).to(dev)
        with spans.span("extract", B * unit), record("extract"):
            feats = system.extract(x)
        if stretch["on"]:
            stretch["k2"].append(feats)
        Ts, flags = [], []
        for i in range(unit):
            lane_feats = [feats[b * unit + i] for b in range(B)]
            states = st["state"]
            lane_caps = []
            if i in want:
                gstates = [gg.get_state() for gg in gens()]
                lane_caps = [Capture(drive, pos + i, b, key, b * unit + i, pre_state=states,
                                     gen_state=gstates[b], feats=lane_feats[b])
                             for b in range(B)]
            if stretch["on"]:
                for b in range(B):
                    kf = lane_of(states, b).keyframe
                    stretch["k1"].append((kf.kp_valid, lane_feats[b].valid,
                                          lane_feats[b].desc.shape[-1]))
            with spans.span("step", B), record("step"), k1_for(lane_caps[0] if lane_caps else None):
                states, outs = system.mstep(states, lane_feats)
            st["state"] = states
            for c in lane_caps:
                c.out, c.post_state, c.k1 = outs, states, lane_caps[0].k1
                caps.append(c)
            Ts.append(stack_lanes(torch, outs, "T_wc"))
            flags.append(torch.stack([stack_lanes(torch, outs, "did_reset"),
                                      stack_lanes(torch, outs, "is_keyframe")], dim=1))
        with record("readback"):
            T = torch.stack(Ts, dim=1)  # (B, C, 4, 4)
            fl = torch.stack(flags, dim=1)  # (B, C, 2)
            host = _read_host(torch, T.reshape(B * unit, 4, 4), fl.reshape(B * unit, 2))
        host = host.reshape(B, unit, -1)
        for b in range(B):
            outcomes.add(b, drive, pos, host[b, :, :16].reshape(-1, 4, 4), host[b, :, 16],
                         host[b, :, 17])

    def unit_online(g, check):
        drive, pos = divmod(g, F)
        if pos == 0:
            system.fresh()
        img = frames[0, pos]
        want = arm(drive, pos, 1, check, (drive, pos))
        if want:
            batches[(drive, pos)] = img
        t0 = time.perf_counter()
        out = engine.process_frame(img)
        if not stretch["on"]:
            latencies.append(time.perf_counter() - t0)
        disarm(want)
        outcomes.add(0, drive, pos, np.asarray(out.T_wc)[None], np.asarray(out.did_reset)[None],
                     np.asarray(out.is_keyframe)[None])

    run_unit = {"chunked": unit_chunked, "lanes": unit_lanes, "online": unit_online}[mode]

    def sync():
        if cuda:
            torch.cuda.synchronize()

    with precision, torch.no_grad():
        # ---- warm-up: every branch of the step (bootstrap, initialisation,
        # tracking, keyframe) on the cell's own shapes, then a fresh drive
        warm = int(traffic["warmup_frames"])
        for g in range(0, warm, unit):
            run_unit(g, check=False)
        sync()
        caps.clear()
        batches.clear()
        outcomes = Outcomes(drives, F)
        latencies.clear()
        counters = _zero_counters() if program else None
        setup_s = time.perf_counter() - t_start
        log(f"set-up {setup_s:.2f} s: imports and build {t_built - t_start:.2f} s, waiting "
            f"for frames {t_frames - t_built:.2f} s, warm-up {time.perf_counter() - t_frames:.2f} s")

        # ---- the window; what set-up left is frozen out of the collector's scans
        gc.collect()
        gc.freeze()
        spans.on = trace
        s0 = int(traffic["trace"]["stretch_start"]) if trace else -1
        s1 = s0 + int(traffic["trace"]["stretch_frames"]) if trace else -1
        prof, prof_wall = None, 0.0
        min_frames = int(traffic["check"]["drives"]) * F if until_checked else 0
        unit_s: list[float] = []  # each unit's time outside the profiled stretch
        t0 = time.perf_counter()
        deadline = t0 + seconds
        g = 0
        while True:
            if g == s0:
                from torch.profiler import ProfilerActivity, profile

                sync()
                spans.on, stretch["on"] = False, True
                acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
                prof = profile(activities=acts)
                prof.__enter__()
                t_prof = time.perf_counter()
            tu = time.perf_counter()
            run_unit(g, check=True)
            if not stretch["on"]:
                unit_s.append(time.perf_counter() - tu)
            g += unit
            if g == s1:
                sync()
                prof_wall = time.perf_counter() - t_prof
                prof.__exit__(None, None, None)
                spans.on, stretch["on"] = True, False
            if (time.perf_counter() >= deadline and (not trace or g >= s1)
                    and g >= min_frames):
                break
        sync()
        window_s = time.perf_counter() - t0
        gc.unfreeze()
    matcher.match_top2 = top2
    lane_frames = g * B

    mem_peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    if cuda:
        for line in card_lines(torch)[1:]:
            log(line)
    if counters is not None:
        launches = _read_counters(counters)
        print("launches per frame: " + json.dumps(
            {k: v / max(1, lane_frames) for k, v in launches.items()}), flush=True)
    for line in outcomes.lines():
        print("drive " + line, flush=True)
    print(f"unit of {unit} frames, ms: " + json.dumps([round(1e3 * u, 3) for u in unit_s]),
          flush=True)

    e2e = {"setup_s": setup_s, "fps": lane_frames / window_s}
    if latencies:
        e2e["frame_p95_ms"] = 1e3 * float(np.percentile(latencies, 95))
    metrics = {}
    breakdown = None
    device_extra = {}
    if not trace:
        for m in cell.end_to_end:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        profile_data = read_profile(prof, prof_wall) if prof is not None else None
        tdata = _trace_data(torch, mode, config, spans, stretch, profile_data, latencies,
                            B, unit, int(traffic["trace"]["stretch_frames"]))
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"], root)(tdata)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if profile_data is not None:
            device_extra = {"busy_s": profile_data["busy_s"], "window_s": profile_data["window_s"]}
            breakdown = {"device_ops": profile_data["device_ops"],
                         "idle_gaps": profile_data["idle_gaps"]}

    found = forbidden_modules()
    # ---- the check, with the program's state freed
    del system, engine, st
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    from vobench.harness.judge import Reference, judge

    t_check = time.perf_counter()
    ref = Reference(config, seed, K, torch.device(ref_device) if ref_device else dev, root,
                    draw_device=dev)
    expanded = [_lane_capture(c) for c in caps]
    nums, compared, detail = judge(ref, expanded, batches, float(limits["kp_tol_px"]))
    nums = {k: v for k, v in nums.items() if k in limits}  # what this cell compares
    # every checked frame handed in during the window has to have been seen
    # and compared whole, so that a path that routes around the hooks fails
    due = B * sum(d * F + p < g for d, ps in plan.positions.items() for p in ps)
    nums["frames_unchecked"] = float(due - compared)
    limits = dict(limits, frames_unchecked=0)
    checks = {k: {"value": v, "limit": limits[k]} for k, v in nums.items()}
    correct = all(v <= limits[k] for k, v in nums.items()) and compared > 0
    log(f"check: {compared} of {due} frames due compared in {time.perf_counter() - t_check:.1f} s")

    result = {
        "correct": bool(correct), "attempted": lane_frames, "failed": outcomes.failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": mem_peak, **device_extra},
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    result["_forbidden"] = found
    result["_detail"] = detail
    return result


def lane_of(x, b):
    """Lane b of a batched NamedTuple of tensors, or item b of a list."""
    if isinstance(x, list):
        return x[b]
    if hasattr(x, "_fields"):
        return type(x)(*(lane_of(v, b) for v in x))
    return x[b]


def stack_lanes(torch, outs, name):
    if isinstance(outs, list):
        return torch.stack([getattr(o, name) for o in outs])
    return getattr(outs, name)


def _lane_capture(c: Capture) -> Capture:
    """A lanes capture cut down to its own lane; others as they are."""
    if not isinstance(c.pre_state, list) and c.lane == 0 and not _batched(c.pre_state):
        return c
    k1 = c.k1
    if k1 is not None and k1[0].dim() == 2:  # K1's lane axis
        k1 = tuple(x[c.lane] for x in k1)
    return Capture(c.drive, c.pos, c.lane, c.batch_key, c.batch_index,
                   pre_state=lane_of(c.pre_state, c.lane), gen_state=c.gen_state,
                   feats=c.feats, out=lane_of(c.out, c.lane),
                   post_state=lane_of(c.post_state, c.lane), net=c.net, k1=k1)


def _batched(state) -> bool:
    return state is not None and state.T_wc.dim() == 3


def _zero_counters() -> dict:
    """The program's kernel launch counters, zeroed: K1, K2 (and its TMA and
    scalar routes), K3."""
    from visualodometry_tpu_torch.ops import match_top2, patches, pyramid

    match_top2.launches = patches.launches = pyramid.launches = 0
    patches.routes.update(tma=0, scalar=0)
    return {"K1": (match_top2, "launches"), "K2": (patches, "launches"),
            "K3": (pyramid, "launches")}


def _read_counters(counters: dict) -> dict:
    from visualodometry_tpu_torch.ops import patches

    out = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
    out.update({f"K2_{r}": n for r, n in patches.routes.items()})
    return out


def _trace_data(torch, mode, config, spans, stretch, profile_data, latencies, B, unit,
                stretch_frames) -> dict:
    """What the per-layer readers read: spans, counts, and the profiled
    stretch with the work it held counted from shapes."""
    from vobench.harness import counts

    vo = config["vo_config"]
    data = {"mode": mode, "lanes": B, "spans": spans.summary(),
            "latencies_s": list(latencies), "profile": profile_data}
    if profile_data is None:
        return data
    lane_frames = stretch_frames * B
    k1_flops = k1_bytes = 0.0
    for kf_valid, valid, d in stretch["k1"]:
        f, b = counts.k1_call(int(kf_valid.sum()), int(valid.sum()), int(d))
        k1_flops, k1_bytes = k1_flops + f, k1_bytes + b
    k2_bytes = 0.0
    launches = counts.k2_launches(vo)
    slices = counts.octave_slices(vo) if launches else []
    for feats in stretch["k2"]:
        for f in feats:
            for o, L, rows, cols, _k, py, px in launches:
                s, e = slices[o]
                k2_bytes += counts.k2_call(L, rows, cols, int(f.valid[s:e].sum()), py, px)
    H, W = counts.padded_frame(vo["image_size"])
    net_flops = (counts.superpoint_dense_flops(H, W) * stretch["net_frames"]
                 if vo["extractor_type"] == "superpoint" else 0.0)
    data["stretch"] = {"lane_frames": lane_frames, "k1_flops": k1_flops, "k1_bytes": k1_bytes,
                       "k2_bytes": k2_bytes if launches else None, "net_flops": net_flops}
    return data


def _plant(system, mode, fault, matcher):
    """A fault in the timed path, for the tests that show the check fails.
    `unobserved_step` and `unobserved_k1` compute rightly but route around
    the harness's hooks: the program's step, or K1 through the matcher."""
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    if fault == "unobserved_k1":
        matcher.match_top2 = matcher.match_top2.__wrapped__
        return
    if fault == "unobserved_step":
        if mode == "online":
            system.engine._step = system.engine._step.__wrapped__
        elif mode == "chunked":
            system.run = system.unobserved()
        else:
            raise ValueError("lanes: the harness itself calls the multi-sequence step")
        return
    if fault == "half_batch":
        inner = system.extract if mode == "lanes" else None

        def halve(feats):
            n = len(feats)
            half = n // 2
            return list(feats[:half]) + list(feats[:n - half])

        if mode == "lanes":
            system.extract = lambda x: halve(inner(x))
        else:  # the extractor that run_chunk calls, inside its observer
            obs = system.run.extract
            fn = obs.__wrapped__
            obs.__wrapped__ = lambda x: halve(fn(x))
        return

    def altered(state, new, out):
        if fault == "frozen_state":
            return state, out
        return new, out._replace(T_wc=out.T_wc + _shift(out.T_wc))

    if mode in ("online", "chunked"):
        obs = system.engine._step if mode == "online" else system.run.step
        fn = obs.__wrapped__

        def wrapped(state, feats, *rest):
            new, out = fn(state, feats, *rest)
            return altered(state, new, out)

        wrapped.generator = fn.generator
        obs.__wrapped__ = wrapped
        return
    mstep = system.mstep

    def mwrapped(states, feats):
        new, outs = mstep(states, feats)
        return altered(states, new, outs)

    mwrapped.generators = mstep.generators
    system.mstep = mwrapped


def _shift(T):
    """0.05 along the camera's x in every pose: an answer altered."""
    import torch

    d = torch.zeros_like(T)
    d[..., 0, 3] = 0.05
    return d
