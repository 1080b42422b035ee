"""How `correct` is decided: the program's outputs against the reference.

During the window the harness keeps, for a sample of frames drawn from
the seed (each checked drive's first frame and `frames - 1` more), what the
timed path produced there: the features, the step's state before and
after the frame, the RANSAC generator's state before it, the step's
outputs, and for SuperPoint the network's outputs. After the window, with
the program's state freed, the plain reference (vobench/reference, which
imports nothing of the program) recomputes each stage from its inputs:

- extraction from the raw frames, batched as the program batched them:
  `kp_unmatched` (share of valid keypoints, on either side, with no
  keypoint of the other side within `kp_tol_px`), `desc_gap` (the largest
  absolute difference of a descriptor entry between paired keypoints) and,
  for SuperPoint, `net_gap` (the largest absolute difference of the score
  heatmap or the coarse descriptors out of the network);
- K1's top-2 search on the keyframe's and the frame's descriptors:
  `k1_gap` (the largest absolute difference of a valid query's best or
  second squared distance), and with the Lowe test `match_mismatch` (share
  of matched slots, on either side, whose validity or index differs);
- the VO step, from the program's state before the frame, on the program's
  features and match, with the same RANSAC draws (the generator's state):
  `pose_gap`, the median over the frames compared of each frame's largest
  relative gap of poses (the frame's, the state's, the keyframe's), and
  `id_mismatch`, the median of each frame's largest share of landmark ids
  that differ (1 where a flag or the frame count differs). Medians,
  because a reference that differs only in float order (the CPU's) flips
  a RANSAC choice on one to three frames in sixteen, and on those frames
  the gaps are as large as a lower precision gives; on the others they
  stay far under it (PERF.md section 2).

A frame counts as compared only where every one of these was seen on the
timed path (features, K1's output, the step's state and outputs, and the
network's outputs for SuperPoint); the caller fails the run unless every
checked frame handed in was compared.

The step is followed from the program's own state: the reference cannot
replay 64 frames of RANSAC and land on the same track (float order moves
it), so each stage is held alone, and the state the program carries from
frame to frame is held by comparing the state after each checked frame.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass
class Capture:
    drive: int
    pos: int
    lane: int
    batch_key: tuple  # the extraction call that produced this frame
    batch_index: int  # its index in that call's batch
    pre_state: object = None
    gen_state: object = None
    feats: object = None
    out: object = None
    post_state: object = None
    net: tuple | None = None  # (score logits (H, W), coarse desc (256, h, w))
    k1: tuple | None = None  # K1's (best d2, second d2, best index) for the frame


@dataclass
class Plan:
    """Which (drive, position) frames the check reads."""

    positions: dict = field(default_factory=dict)  # drive -> set of positions

    @staticmethod
    def draw(seed: int, drives: int, frames: int, drive_frames: int) -> "Plan":
        rng = np.random.default_rng([int(seed), 7919])
        pos = {}
        for d in range(drives):
            rest = rng.choice(np.arange(1, drive_frames - 1), frames - 1, replace=False)
            pos[d] = {0, *(int(p) for p in rest)}
        return Plan(pos)

    def wants(self, drive: int, pos: int) -> bool:
        return pos in self.positions.get(drive, ())


def to_ref_state(s):
    from vobench.reference.core.state import Keyframe, MapState, VOState

    d = s._asdict()
    d["keyframe"] = Keyframe(*d["keyframe"])
    d["map"] = MapState(*d["map"])
    return VOState(**d)


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    if a.numel() == 0:
        return 0.0
    scale = torch.clamp(b.abs(), min=1.0)
    return float(((a - b).abs() / scale).max())


def _share(a, b, mask=None) -> float:
    """Share of entries that differ (among `mask`)."""
    d = a.cpu() != b.cpu()
    if mask is not None:
        d = d[mask.cpu()]
    return float(d.float().mean()) if d.numel() else 0.0


def step_gaps(po, ro, ps, rs) -> tuple[float, float]:
    """(pose, ids) gaps of one frame's step: outputs `po`/`ro` and states
    after the frame `ps`/`rs`, the program's and the reference's. pose: the
    largest relative gap of the frame's pose, the state's pose and last
    position and the keyframe's pose; ids: 1 where a flag or the frame
    count differs, else the largest share of landmark ids that differ, on
    the frame's keypoints, the keyframe's and the map's live slots."""
    pose = max(_rel(po.T_wc, ro.T_wc), _rel(ps.T_wc, rs.T_wc), _rel(ps.last_pos, rs.last_pos),
               _rel(ps.keyframe.T_wc, rs.keyframe.T_wc))
    flags = [(po.is_keyframe, ro.is_keyframe), (po.did_reset, ro.did_reset),
             (ps.frame_id, rs.frame_id), (ps.initialized, rs.initialized),
             (ps.has_keyframe, rs.has_keyframe)]
    if any(not torch.equal(a.cpu(), b.cpu()) for a, b in flags):
        return pose, 1.0
    ids = max(_share(po.curr_ids, ro.curr_ids), _share(ps.keyframe.ids, rs.keyframe.ids),
              _share(ps.map.ids, rs.map.ids, rs.map.ids >= 0))
    return pose, ids


def keypoint_gaps(pf, rf, tol: float) -> tuple[float, float]:
    """(kp_unmatched, desc_gap) of the program's features against the
    reference's."""
    P, Q = pf.kps[pf.valid].double(), rf.kps[rf.valid].double()
    if len(P) == 0 and len(Q) == 0:
        return 0.0, 0.0
    if len(P) == 0 or len(Q) == 0:
        return 1.0, 0.0
    d = torch.cdist(P, Q)
    dp, ip = d.min(dim=1)
    dq, _ = d.min(dim=0)
    unmatched = float((dp > tol).sum() + (dq > tol).sum()) / (len(P) + len(Q))
    near = dp <= tol
    if not bool(near.any()):
        return unmatched, 0.0
    DP = pf.desc[pf.valid][near].double()
    DQ = rf.desc[rf.valid][ip[near]].double()
    return unmatched, float((DP - DQ).abs().max())


def match_mismatch(p_idx, p_valid, r) -> float:
    diff = (p_valid != r.valid) | (p_valid & (p_idx != r.idx))
    either = int((p_valid | r.valid).sum())
    return float(diff.sum()) / max(1, either)


def _on(x, dev):
    """Tensors of x (a tensor, or NamedTuples and tuples of them) on dev."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, tuple):
        items = [_on(v, dev) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


class Reference:
    """The plain reference of one cell, on `dev`, drawing its RANSAC
    samples on `draw_device` (the program's device: a generator's draws
    differ between devices)."""

    def __init__(self, cell_config, seed, K, dev, root, draw_device=None):
        from vobench.harness.systems import reference_extractor, vo_config
        from vobench.reference.core.step import make_step_fn
        from vobench.reference.estimation.ransac import _INT32_MAX

        self.cfg = cfg = vo_config(cell_config, seed, program=False)
        self.dev = dev
        self.extract = reference_extractor(cfg, cell_config, dev, root)
        draw_device = torch.device(draw_device or dev)
        sampler = None
        if draw_device != dev:
            gen = torch.Generator(device=draw_device)

            def sampler(valid, num_hypotheses, sample_size):  # sample_valid_indices's
                order = torch.argsort((~valid).to(torch.int8), stable=True)
                count = torch.clamp(torch.sum(valid), min=1)
                draws = torch.randint(0, _INT32_MAX, (num_hypotheses, sample_size),
                                      generator=gen, device=draw_device)
                return order[draws.to(dev) % count]

        self.step = make_step_fn(cfg, K, device=dev, sampler=sampler)
        self.generator = self.step.generator if sampler is None else gen
        self.desc_dim = 256 if cfg.extractor_type == "superpoint" else 128
        self._batches = {}

    def features(self, imgs: torch.Tensor, index: int, key=None):
        """Features of frame `index` of the batch `imgs` ((B, H, W), or one
        (H, W) frame with index None), extracted as the program batched it;
        and the network's (heat, coarse desc) for SuperPoint."""
        cfg = self.cfg
        if cfg.extractor_type == "superpoint":
            from vobench.reference.models.superpoint import select_keypoints

            batch = imgs if imgs.dim() == 3 else imgs[None]
            i = 0 if imgs.dim() == 2 else index
            if key is None or key not in self._batches:  # one network pass a batch
                self._batches = {key: self.extract.heads(batch)}
            heat, desc = self._batches[key]
            f = select_keypoints(heat[i], desc[i], cfg.padded_keypoints, self.extract.threshold)
            return f, (heat[i], desc[i])
        from vobench.reference.frontend import sift

        if key is None or key not in self._batches:  # one pyramid a batch
            self._batches = {key: sift._pyramid(imgs.to(self.dev), cfg, "auto")}
        gauss, dogs = self._batches[key]
        if imgs.dim() == 2:
            return sift.extract_sift_from_pyramid((gauss, dogs), cfg), None
        return sift.extract_sift_from_pyramid(
            ([g[index] for g in gauss], [d[index] for d in dogs]), cfg), None

    def match(self, kf, feats):
        from vobench.reference.frontend.matcher import match_descriptors

        return match_descriptors(kf.desc, kf.kp_valid, feats.desc, feats.valid,
                                 ratio=self.cfg.lowe_ratio, mutual=self.cfg.mutual_check)


def seen(c: Capture, superpoint: bool) -> bool:
    """Whether the hooks saw everything of the frame that the check reads."""
    parts = (c.pre_state, c.gen_state, c.feats, c.out, c.post_state, c.k1)
    return all(x is not None for x in parts) and (c.net is not None or not superpoint)


@torch.no_grad()
def judge(ref: Reference, captures: list, batches: dict, tol: float) -> tuple[dict, int, list]:
    """The compared numbers over every capture that was seen whole, each
    the largest reading; how many captures were compared; and each
    frame's readings by kind."""
    from vobench.reference.frontend.interface import Features
    from vobench.reference.frontend.matcher import MatchResult

    from vobench.reference.ops.match_top2 import _BIG, _top2_torch

    nums = {"kp_unmatched": 0.0, "desc_gap": 0.0, "k1_gap": 0.0, "match_mismatch": 0.0}
    if ref.cfg.extractor_type == "superpoint":
        nums["net_gap"] = 0.0
    compared = 0
    imgs_of = {}
    detail = []
    for c in captures:
        if not seen(c, "net_gap" in nums):
            continue
        compared += 1
        c = Capture(c.drive, c.pos, c.lane, c.batch_key, c.batch_index,
                    **{k: _on(getattr(c, k), ref.dev)
                       for k in ("pre_state", "feats", "out", "post_state", "net", "k1")},
                    gen_state=c.gen_state)
        if c.batch_key not in imgs_of:
            imgs_of = {c.batch_key: torch.as_tensor(batches[c.batch_key]).to(ref.dev)}
        imgs = imgs_of[c.batch_key]
        rf, net = ref.features(imgs, c.batch_index, c.batch_key)
        pf = Features(*c.feats)
        unm, dg = keypoint_gaps(pf, rf, tol)
        row = {"drive": c.drive, "pos": c.pos, "lane": c.lane, "kp_unmatched": unm,
               "desc_gap": dg}
        nums["kp_unmatched"] = max(nums["kp_unmatched"], unm)
        nums["desc_gap"] = max(nums["desc_gap"], dg)
        if net is not None:
            heat = torch.sigmoid(c.net[0].float())
            cdesc = c.net[1].float().permute(1, 2, 0)
            g = max(float((heat - net[0]).abs().max()), float((cdesc - net[1]).abs().max()))
            nums["net_gap"] = max(nums["net_gap"], g)
            row["net_gap"] = g
        pre = to_ref_state(c.pre_state)
        rb, rs, _ = _top2_torch(pre.keyframe.desc, pf.desc, pf.valid)
        q = pre.keyframe.kp_valid & (rb < _BIG)
        qs = q & (rs < _BIG)
        g = max([float((c.k1[0] - rb)[q].abs().max()) if bool(q.any()) else 0.0,
                 float((c.k1[1] - rs)[qs].abs().max()) if bool(qs.any()) else 0.0])
        nums["k1_gap"] = max(nums["k1_gap"], g)
        rm = ref.match(pre.keyframe, pf)
        mm = match_mismatch(c.out.match_idx, c.out.match_valid, rm)
        nums["match_mismatch"] = max(nums["match_mismatch"], mm)
        row.update(k1_gap=g, match_mismatch=mm)
        ref.generator.set_state(c.gen_state)
        r_state, r_out = ref.step(pre, pf, match=MatchResult(c.out.match_idx, c.out.match_valid))
        pose, ids = step_gaps(c.out, r_out, to_ref_state(c.post_state), r_state)
        row.update(pose_gap=pose, id_mismatch=ids)
        detail.append(row)
    # the step's numbers are medians over the frames: a float order that
    # differs flips a RANSAC choice on a few frames, and that frame's gaps
    # are then as large as a lower precision's (PERF.md section 2)
    for k in ("pose_gap", "id_mismatch"):
        nums[k] = float(np.median([r[k] for r in detail])) if detail else 0.0
    return nums, compared, detail
