"""The system under test, built from a cell's configuration and mix.

`program=True` builds it from `visualodometry_tpu_torch` (the port):

- `chunked`: `make_chunked_pipeline_fn`'s `run_chunk(state, imgs)`, the
  program's entry point, called once a chunk. It is built with its
  extractor and step seen through `observe` (see `Observed`), so that the
  harness's spans and the check's captures sit around the calls that
  run_chunk itself makes;
- `lanes`: `make_batched_extract_fn` over lanes x chunk frames, then the
  multi-sequence step `make_multiseq_step_fn` frame by frame;
- `online`: `VOEngine.process_frame`, one frame a call.

`program=False` builds the control: the plain reference
(vobench/reference) in the program's place, with the same interface; the
caller runs it under `reference.precision.lowered()`.
"""

from __future__ import annotations

import numpy as np
import torch


def vo_config(cell_config: dict, seed: int, program: bool):
    d = dict(cell_config["vo_config"], seed=int(seed))
    if program:
        from visualodometry_tpu_torch import config_from_dict
    else:
        from vobench.reference.config import config_from_dict
    return config_from_dict(d)


def weights_path(cell_config: dict, root) -> str | None:
    w = cell_config.get("weights")
    return None if w is None else str(root / w)


class Observed:
    """`fn` called through `hook(fn, *args)`; its other attributes are fn's.
    `__wrapped__` is fn, for a fault that routes around the hook."""

    def __init__(self, fn, hook):
        self.__wrapped__, self._hook = fn, hook

    def __call__(self, *args, **kwargs):
        return self._hook(self.__wrapped__, *args, **kwargs)

    def __getattr__(self, name):
        return getattr(self.__wrapped__, name)


def _identity(fn):
    return fn


class Chunked:
    """run(state, imgs (C, H, W) uint8 on the host) -> (state, stacked
    StepOutput); `observe = (wrap_extract, wrap_step)` wraps the extractor
    and the step that run calls."""

    def __init__(self, cell_config, seed, K, dev, root, program=True, observe=None):
        self.cfg = cfg = vo_config(cell_config, seed, program)
        self.desc_dim = 256 if cfg.extractor_type == "superpoint" else 128
        self.dev, self.K, self.pyramid_impl = dev, K, cell_config["pyramid_impl"]
        wrap_extract, wrap_step = observe or (_identity, _identity)
        if program:
            from visualodometry_tpu_torch.core import runner
            from visualodometry_tpu_torch.core.state import init_state

            # run_chunk closes over what these factories return
            names = ("make_step_fn", "make_batched_extract_fn",
                     "make_batched_superpoint_extract_fn")
            saved = {n: getattr(runner, n) for n in names}
            wraps = {"make_step_fn": wrap_step, "make_batched_extract_fn": wrap_extract,
                     "make_batched_superpoint_extract_fn": wrap_extract}
            for n in names:
                setattr(runner, n, lambda *a, _f=saved[n], _w=wraps[n], **k: _w(_f(*a, **k)))
            try:
                self.run = runner.make_chunked_pipeline_fn(cfg, K, device=dev,
                                                           pyramid_impl=self.pyramid_impl)
            finally:
                for n in names:
                    setattr(runner, n, saved[n])
            step, extract = self.run.step, self.run.extract
        else:
            from vobench.reference.core.state import StepOutput, init_state
            from vobench.reference.core.step import make_step_fn

            extract = wrap_extract(reference_extractor(cfg, cell_config, dev, root))
            step = wrap_step(make_step_fn(cfg, K, device=dev))

            def run_chunk(state, imgs):  # the program's run_chunk, over the reference
                feats = extract(torch.as_tensor(imgs).to(dev))
                outs = []
                for f in feats:
                    state, out = step(state, f)
                    outs.append(out)
                return state, StepOutput(*(torch.stack(x) for x in zip(*outs)))

            run_chunk.extract, run_chunk.step = extract, step
            self.run = run_chunk
        self.model = getattr(extract, "model", None)
        self._init_state = init_state
        self._gen = step.generator

    def unobserved(self):
        """The program's run_chunk built plainly: what a fault that routes
        around the observed step runs."""
        from visualodometry_tpu_torch.core.runner import make_chunked_pipeline_fn

        return make_chunked_pipeline_fn(self.cfg, self.K, device=self.dev,
                                        pyramid_impl=self.pyramid_impl)

    def fresh(self):
        return self._init_state(self.cfg, desc_dim=self.desc_dim, device=self.dev)

    def generators(self):
        return [self._gen]


class Lanes:
    """extract(imgs (B*C, H, W)) -> B*C Features, lane-major; mstep(states,
    [B Features]) -> (states, outs) with the lane axis leading."""

    def __init__(self, cell_config, seed, K, dev, root, lanes, program=True):
        self.cfg = cfg = vo_config(cell_config, seed, program)
        self.desc_dim = 256 if cfg.extractor_type == "superpoint" else 128
        self.dev, self.lanes, self.model = dev, lanes, None
        if program:
            from visualodometry_tpu_torch.frontend.sift import make_batched_extract_fn
            from visualodometry_tpu_torch.parallel.multiseq import (
                init_batched_state,
                make_multiseq_step_fn,
            )

            if cfg.extractor_type != "sift":
                raise ValueError("lanes: the SIFT extractor only")
            self.extract = make_batched_extract_fn(cfg, device=dev,
                                                   pyramid_impl=cell_config["pyramid_impl"])
            self.mstep = make_multiseq_step_fn(cfg, K, device=dev)
            self._fresh = lambda: init_batched_state(cfg, self.desc_dim, lanes, device=dev)
        else:
            from vobench.reference.core.state import init_state
            from vobench.reference.core.step import make_step_fn

            self.extract = reference_extractor(cfg, cell_config, dev, root)
            steps = []
            for b in range(lanes):  # lane b draws from seed + b, as the program's
                s = make_step_fn(cfg, K, device=dev)
                s.generator.manual_seed(cfg.seed + b)
                steps.append(s)

            def mstep(states, feats):
                new, outs = zip(*(st(s, f) for st, s, f in zip(steps, states, feats)))
                return list(new), list(outs)

            mstep.generators = [s.generator for s in steps]
            self.mstep = mstep
            self._fresh = lambda: [init_state(cfg, self.desc_dim, device=dev)
                                   for _ in range(lanes)]
        self._gens = self.mstep  # made on the first call

    def fresh(self):
        return self._fresh()

    def generators(self):
        return list(self._gens.generators)


class Online:
    """The per-frame engine: `engine.process_frame(img) -> StepOutput` on the host."""

    def __init__(self, cell_config, seed, K, dev, root, program=True):
        self.cfg = cfg = vo_config(cell_config, seed, program)
        self.desc_dim = 256 if cfg.extractor_type == "superpoint" else 128
        self.dev, self.model = dev, None
        if program:
            from visualodometry_tpu_torch.core.pipeline import VOEngine
            from visualodometry_tpu_torch.core.state import init_state

            self.engine = VOEngine(K, cfg, device=dev)
            self.model = getattr(self.engine._extract, "model", None)
        else:
            from vobench.reference.core.state import init_state

            self.engine = _ReferenceEngine(cfg, cell_config, K, dev, root)
            self.model = getattr(self.engine._batch, "model", None)
        self._init_state = init_state
        self._gen = self.engine._step.generator

    def fresh(self):
        """A new drive: a fresh VO state and empty host logs; the RANSAC
        generator runs on."""
        e = self.engine
        e.state = self._init_state(self.cfg, desc_dim=self.desc_dim, device=self.dev)
        for name in ("trajectory", "_kf_log", "_traj_kf"):
            if hasattr(e, name):
                setattr(e, name, [])
        if hasattr(e, "_kf_window"):
            e._kf_window.clear()
        if hasattr(e, "_ba_edges"):
            e._ba_edges = {}
        e.frame_id = 0

    def generators(self):
        return [self._gen]


class _ReferenceEngine:
    """The control's engine: extract one frame, step, outputs to the host."""

    def __init__(self, cfg, cell_config, K, dev, root):
        from vobench.reference.core.state import StepOutput
        from vobench.reference.core.step import make_step_fn

        self._batch = batch = reference_extractor(cfg, cell_config, dev, root)
        self._extract = lambda img: batch(torch.as_tensor(img)[None].to(dev))[0]
        self._step = make_step_fn(cfg, K, device=dev)
        self._out = StepOutput
        self.state, self.frame_id = None, 0

    def process_frame(self, img):
        feats = self._extract(img)
        self.state, out = self._step(self.state, feats)
        self.frame_id += 1
        return self._out(*(x.cpu().numpy() for x in out))


def reference_extractor(cfg, cell_config, dev, root):
    """The reference's batched extractor for the configuration."""
    if cfg.extractor_type == "superpoint":
        from vobench.reference.frontend.superpoint import make_batched_superpoint_extract_fn

        return make_batched_superpoint_extract_fn(cfg, weights_path(cell_config, root),
                                                  device=dev)
    from vobench.reference.frontend.sift import make_batched_extract_fn

    return make_batched_extract_fn(cfg, device=dev, pyramid_impl=cell_config["pyramid_impl"])


def build(mode, cell_config, seed, K, dev, root, lanes=1, program=True, observe=None):
    K = np.asarray(K, np.float32)
    if mode == "chunked":
        return Chunked(cell_config, seed, K, dev, root, program, observe)
    if mode == "lanes":
        return Lanes(cell_config, seed, K, dev, root, lanes, program)
    if mode == "online":
        return Online(cell_config, seed, K, dev, root, program)
    raise ValueError(f"unknown traffic mode {mode!r}")
