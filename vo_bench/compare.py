"""The comparison that decides `correct`: each number compared, over the
samples of a run, between what the timed path produced and the plain
reference (`vo_bench/reference`), and its limit (`vo_bench/limits/<cell>.
json`).

Each number is taken at the run's worst sample. Extraction, LK and pose
GN are compared from the step's inputs; matching, triangulation, the
keyframe decision and the merge from the candidate's own upstream outputs
(its keypoints, descriptors, pose and kept slots), so that a rounding
difference upstream cannot cascade into the merge; the host's replay of
the step's record and the apply of a solve from the program's own host
state before them:
- kp: share of the K keypoint slots whose mask or position differ;
- desc: share of descriptor bits that differ, over slots valid in both at
  one position;
- counts: largest relative gap of the LK survivors, the pose inliers and
  the cross-checked matches (`n_flow`, `n_ba`, `n_matches`);
- keep: share of LK's live slots whose LK status or pose-inlier flag
  differs;
- flow_moved: share of the slots kept by both whose tracked positions
  differ by more than a tenth of LK's stopping step (`lk_eps`) in either
  coordinate, or are not finite: a slot whose last step lands on `lk_eps`
  may stop one iteration apart on the two sides, so the widest gap swings
  by up to a step with rounding alone, while the share stays put;
- flow_px: the widest gap (px) of a tracked position kept by both (not
  finite where a position is not), held to a few LK steps: a handful of
  slots tracked wrong, too few for `flow_moved`'s share;
- pose_rot: angle (degrees) of the step's pose against the reference's;
- pose_trans: the poses' translation gap over the frame's motion;
- landmarks: infinite where the keyframe decision or the merged table
  differ, else the widest gap of a fresh landmark over its depth;
- ba_cost: a window solve's relative gap of the float64 robust cost at
  the program's result against the reference's;
- ba_pose: a window solve's widest pose gap (the translation over the
  window's extent, or the rotation in radians, from the skew part of
  P R^-1);
- replay: share of the track table's slots whose host entry after the
  replay of a step's record (the merge into the host map, the keyframe
  inserted) differs from the plain replay's, plus 1 where the keyframe
  differs;
- apply: a sampled solve's apply, the widest gap of the host state after
  it (every keyframe pose and landmark position, the live and keyframe
  pose) against the plain apply's, over the widest move the plain apply
  makes; infinite where the two part at a gate;
- push: the widest gap of the device state that the first dispatch after
  a sampled push reads (the live and keyframe pose, the live table's
  landmarks) against the host state the push copies, infinite where the
  live slots differ; the first push of each sampled session and the
  first after each sampled apply;
- boot_rot, boot_t, boot_inlier: a session's first two-view bootstrap
  (the start the step comparison follows from): the rotation's angle
  (degrees), the angle between the unit translations (degrees), and the
  share of epipolar inlier flags that differ, over the reference's
  inliers.

A sample whose number cannot be formed (no keyframe in both, no window
solve in the run) leaves that number out of the run; a run with no step
sample at all is not correct.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from vo_bench.reference import bootstrap as ref_boot
from vo_bench.reference import host as ref_host
from vo_bench.reference import step as ref_step
from vo_bench.reference import window as ref_window
from vo_bench.reference.precision import TF32

STEP_NUMBERS = ("kp", "desc", "counts", "keep", "flow_moved", "flow_px",
                "pose_rot", "pose_trans", "landmarks", "replay")
WINDOW_NUMBERS = ("ba_cost", "ba_pose", "apply", "push")
BOOT_NUMBERS = ("boot_rot", "boot_t", "boot_inlier")
NUMBERS = STEP_NUMBERS + WINDOW_NUMBERS + BOOT_NUMBERS


def _share(x: torch.Tensor, over: torch.Tensor) -> float:
    n = int(over.sum())
    return float((x & over).sum()) / n if n else 0.0


def _popcount(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.int64) & 0xFFFFFFFF
    n = torch.zeros_like(x)
    for _ in range(32):
        n += x & 1
        x = x >> 1
    return n


def _pose_gap(P: torch.Tensor, R: torch.Tensor, T_in: torch.Tensor):
    """(angle in degrees, translation gap over the motion from the previous
    pose T_in) of pose P against R (world->camera); the angle from the
    skew part of P R^-1, which keeps its digits at small angles."""
    P, R, T_in = (t.double() for t in (P, R, T_in))
    D = P @ torch.linalg.inv(R)
    S = 0.5 * (D[:3, :3] - D[:3, :3].T)
    s = float(torch.linalg.norm(torch.stack([S[2, 1], S[0, 2], S[1, 0]])))
    motion = float(torch.linalg.norm((R @ torch.linalg.inv(T_in))[:3, 3]))
    return (math.degrees(math.asin(min(s, 1.0))),
            float(torch.linalg.norm(D[:3, 3])) / max(motion, 1e-6))


def track_numbers(cand: dict, ref: dict, x: dict, lk_eps: float) -> dict:
    """Extraction, LK and pose GN: the candidate's outputs against the
    reference's `track` on the same inputs."""
    out = {}
    same_kp = (cand["kp_mask"] == ref["kp_mask"]) & (
        ~ref["kp_mask"] | (cand["kp_uv"] == ref["kp_uv"]).all(-1))
    out["kp"] = float((~same_kp).sum()) / same_kp.numel()
    both = same_kp & ref["kp_mask"]
    n_bits = int(both.sum()) * cand["desc"].shape[1] * 32
    diff = int(_popcount(cand["desc"] ^ ref["desc"])[both].sum())
    out["desc"] = diff / n_bits if n_bits else 0.0
    out["counts"] = max(abs(int(cand[k]) - int(ref[k])) / max(int(ref[k]), 1)
                        for k in ("n_flow", "n_ba"))
    out["keep"] = _share((cand["flow_ok"] != ref["flow_ok"])
                         | (cand["inlier"] != ref["inlier"]), ref["use"])
    kept = cand["keep"] & ref["keep"]
    gap = (cand["flow_uv"] - ref["flow_uv"]).abs().amax(-1)
    out["flow_moved"] = _share(~(gap <= 0.1 * lk_eps), kept)
    out["flow_px"] = float(gap[kept].max()) if bool(kept.any()) else 0.0
    out["pose_rot"], out["pose_trans"] = _pose_gap(cand["pose"], ref["pose"],
                                                   x["pose"])
    return out


def replenish_numbers(cand: dict, ref: dict) -> dict:
    """Matching, triangulation, the keyframe decision and the merge: the
    candidate's outputs against the reference's `replenish` on the
    candidate's own upstream outputs. `landmarks` is infinite where the
    decision or the merged table differ, else the widest gap of a fresh
    landmark over its depth (0 on a frame neither takes as a keyframe)."""
    out = {"counts": abs(int(cand["n_matches"]) - int(ref["n_matches"]))
           / max(int(ref["n_matches"]), 1), "landmarks": 0.0}
    if bool(cand["is_kf"]) != bool(ref["is_kf"]):
        out["landmarks"] = math.inf
    elif bool(ref["is_kf"]):
        n = int(ref["n_new"])
        fresh = ref["valid"] & ~cand["keep"]
        if (int(cand["n_new"]) != n
                or not torch.equal(cand["valid"], ref["valid"])
                or not torch.equal(cand["anchor"][fresh],
                                   ref["anchor"][fresh])
                or not torch.equal(cand["src"][:n], ref["src"][:n])):
            out["landmarks"] = math.inf
        elif n:
            s = ref["src"][:n]
            pts = ref["r_pts"][s].double()
            depth = torch.linalg.norm(
                pts - ref_step.center(cand["pose"].double()), dim=-1)
            gap = torch.linalg.norm(cand["r_pts"][s].double() - pts, dim=-1)
            out["landmarks"] = float((gap / depth.clamp(min=1e-6)).max())
    return out


def program_outputs(sample: dict) -> dict:
    """The program's outputs of a step sample under the reference's names;
    LK's positions come from the record's track table, where a kept slot
    holds LK's position on every frame (only kept slots are read)."""
    r = {k: v.to(sample["kp_uv"].device) for k, v in
         sample["record"].items()}
    return dict(
        kp_uv=sample["kp_uv"], kp_mask=sample["kp_mask"],
        desc=sample["desc"], flow_uv=r["track_uv"], flow_ok=r["flow_ok"],
        pose=r["pose"], inlier=r["inlier"], keep=r["keep"],
        n_flow=r["n_flow"], n_ba=r["n_ba"], n_matches=r["n_matches"],
        n_new=r["n_new"], is_kf=r["is_kf"], src=r["src"],
        r_pts=r["r_pts"], anchor=r["anchor_uv"], valid=r["valid"])


def window_numbers(prob, prog, ref, cam, bc: dict) -> dict:
    """The window numbers of one solve: `prog` and `ref` are (poses,
    landmarks)."""
    kw = dict(huber_delta=bc["huber_delta"],
              pose_prior_weight=bc["pose_prior_weight"])
    c_prog = ref_window.cost64(prob, prog[0], prog[1], cam, **kw)
    c_ref = ref_window.cost64(prob, ref[0], ref[1], cam, **kw)
    valid = prob.pose_valid
    P, R = prog[0].double()[valid], ref[0].double()[valid]
    D = P @ torch.linalg.inv(R)
    S = 0.5 * (D[:, :3, :3] - D[:, :3, :3].transpose(1, 2))
    sin = torch.linalg.norm(torch.stack([S[:, 2, 1], S[:, 0, 2], S[:, 1, 0]],
                                        dim=-1), dim=-1)
    centers = -(R[:, :3, :3].transpose(1, 2) @ R[:, :3, 3:])[..., 0]
    extent = float(torch.cdist(centers, centers).max()) if len(R) > 1 else 1.0
    pose = max(float(torch.linalg.norm(D[:, :3, 3], dim=-1).max())
               / max(extent, 1e-6), float(torch.asin(sin.clamp(max=1)).max()))
    c0 = ref_window.cost64(prob, prob.poses, prob.landmarks, cam, **kw)
    return dict(ba_cost=abs(c_prog - c_ref) / max(abs(c_ref), 1e-12),
                ba_pose=pose, cost0=c0, cost_prog=c_prog, cost_ref=c_ref,
                n_poses=int(valid.sum()))


def boot_numbers(cand, ref) -> dict:
    """The bootstrap's numbers: `cand` and `ref` are (R, t, inlier mask)."""
    R = cand[0].double() @ ref[0].double().T
    S = 0.5 * (R - R.T)
    sin = float(torch.linalg.norm(torch.stack([S[2, 1], S[0, 2], S[1, 0]])))
    cos_t = float(torch.clamp(torch.dot(cand[1].double(), ref[1].double()),
                              -1, 1))
    return dict(boot_rot=math.degrees(math.asin(min(sin, 1.0))),
                boot_t=math.degrees(math.acos(cos_t)),
                boot_inlier=float((cand[2] != ref[2]).sum())
                / max(int(ref[2].sum()), 1))


def replay_number(replay: dict, record: dict, control: bool) -> float:
    """The replay number of a step sample (None where the step reset)."""
    if replay["post"] is None:
        return None
    r = {k: v.numpy() for k, v in record.items()}
    return ref_host.replay_mismatch(
        replay["pre"], replay["post"], r,
        q=ref_host.bf16 if control else ref_host.same)


def apply_number(entry: dict, bc: dict, control: bool) -> float:
    """The apply number of a sampled solve's apply."""
    pre = entry["pre"]
    ref = ref_host.apply(pre, entry["args"], bc)
    if control:
        cand = ref_host.apply(pre, entry["args"], bc, q=ref_host.bf16)
        applied = cand["applied"]
    else:
        cand = entry["post"]
        applied = cand["n_ba_runs"] > pre["n_ba_runs"]
    gap = ref_host.widest(cand, ref)
    if applied != ref["applied"]:
        return math.inf
    if not applied:
        return 0.0 if gap == 0 else math.inf
    return gap / max(ref_host.widest(ref, pre), 1e-30)


def push_number(entry: dict, control: bool) -> float:
    """The push number of a sampled push; the control's device state is the
    host state rounded to bfloat16."""
    host = entry["host"]
    dev = {k: v.cpu().numpy() for k, v in entry["device"].items()}
    if control:
        dev = {k: (ref_host.bf16(v) if k != "valid" else v)
               for k, v in host.items()}
    if not np.array_equal(dev["valid"], host["valid"]):
        return math.inf
    v = host["valid"]
    return ref_host.widest(
        dict(dev, lm_pos=dev["lm_pos"][v]),
        dict(host, lm_pos=host["lm_pos"][v]), ("pose", "kf_pose", "lm_pos"))


def to_inputs(snap) -> dict:
    return dict(zip(ref_step.INPUT_KEYS, snap))


def to_problem(prob) -> ref_window.Problem:
    return ref_window.Problem(*(t.clone() for t in prob))


def solve_reference(prob, cam, bc: dict):
    """The reference's window solve at the frontend's settings (two pinned
    poses, the configuration's prior)."""
    poses, lms, _ = ref_window.solve_window_plain(
        prob, cam, iters=bc["iters"], huber_delta=bc["huber_delta"],
        damping=bc["damping"], n_fixed_poses=2,
        pose_prior_weight=bc["pose_prior_weight"])
    return poses, lms


def judge(audit, vo: dict, cam, control: bool = False) -> dict:
    """The numbers of a run over its samples: the program against the
    reference, or, with `control`, the control (the reference one
    precision below the configuration's) in the program's place. Returns
    {number: largest over the samples}, with "samples", "solves",
    "applies", "pushes", "bootstraps" and "detail" (each sample's
    numbers)."""
    out = {k: [] for k in NUMBERS}
    detail = []
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for key in sorted(audit.steps):
        s = audit.steps[key]
        x = to_inputs(s["inputs"])
        ref = ref_step.track(x, vo, cam)
        if control:
            with TF32():
                cand = ref_step.step(x, vo, cam, low=True)
        else:
            cand = program_outputs(s)
        nums = track_numbers(cand, ref, x, vo["tracking"]["lk_eps"])
        rep = replenish_numbers(cand, ref_step.replenish(x, vo, cam, cand))
        nums["counts"] = max(nums["counts"], rep.pop("counts"))
        nums.update(rep)
        replay = replay_number(s["replay"], s["record"], control)
        if replay is not None:
            nums["replay"] = replay
        detail.append(dict(nums, frame=list(key), n_ba=int(ref["n_ba"])))
        for k, v in nums.items():
            out[k].append(v)
    bc = vo["ba"]
    for prob, (poses, lms) in audit.solves:
        p = to_problem(prob)
        ref = solve_reference(p, cam, bc)
        if control:
            with TF32():
                prog = solve_reference(p, cam, bc)
        else:
            dev = p.poses.device
            prog = (torch.as_tensor(poses, device=dev),
                    torch.as_tensor(lms, device=dev))
        nums = window_numbers(p, prog, ref, cam, bc)
        detail.append(nums)
        for k, v in nums.items():
            if k in out:
                out[k].append(v)
    for entry in audit.applies:
        out["apply"].append(apply_number(entry, bc, control))
        detail.append(dict(apply=out["apply"][-1], solve=entry["solve"]))
    for entry in audit.pushes:
        out["push"].append(push_number(entry, control))
        detail.append(dict(push=out["push"][-1]))
    rc = vo["ransac"]
    for b in audit.boots.values():
        args = (b["uv1"], b["uv2"], b["mask"], b["K"], b["state"], rc)
        ref = ref_boot.two_view(*args)
        if control:
            with TF32():
                cand = ref_boot.two_view(*args, low=True)
        else:
            cand = (b["R"], b["t"], b["inlier"])
        nums = boot_numbers(cand, ref)
        detail.append(nums)
        for k, v in nums.items():
            out[k].append(v)
    # the worst sample; NaN, which no limit holds, counts as the worst
    res = {k: max(v, key=lambda x: math.inf if math.isnan(x) else x)
           for k, v in out.items() if v}
    res["samples"], res["solves"] = len(audit.steps), len(audit.solves)
    res["applies"], res["pushes"] = len(audit.applies), len(audit.pushes)
    res["bootstraps"] = len(audit.boots)
    res["detail"] = detail
    return res


def verdict(numbers: dict, limits: dict):
    """(correct, [(name, number, limit)]): every number at or under its
    limit, and at least one step sample."""
    rows = [(k, numbers[k], limits[k]) for k in NUMBERS if k in numbers]
    ok = numbers.get("samples", 0) > 0 and all(
        np.isfinite(v) and v <= lim for _, v, lim in rows)
    return bool(ok), rows
