"""The reference against the port at tiny sizes on the CPU, as a run
drives both: sound runs come out correct; the control, and the timed
path broken underneath in each way the cell can break, come out not
correct under the cells' own limits."""

from __future__ import annotations

import pytest
import torch

from portbench.harness import cells
from portbench.tests import tiny

PEM_CELLS = ["pem_base.bin"]


@pytest.mark.parametrize("name", PEM_CELLS + ["ism_sam_h.frame",
                                              "pem_base.train28"])
def test_a_sound_run_is_correct(name):
    rec = tiny.run(name)
    assert rec.attempted > 0 and rec.failed == 0
    assert rec.judged > 0 and not rec.check_errors
    assert rec.correct, (rec.numbers, rec.limits)


@pytest.mark.parametrize("name", PEM_CELLS + ["ism_sam_h.frame",
                                              "pem_base.train28"])
def test_the_control_is_not_correct(name):
    c = tiny.cell(name)
    numbers = cells.load_driver(c.traffic["driver"]).control(c, 5, "cpu")
    over = [k for k, lim in c.limits["numbers"].items() if numbers[k] > lim]
    assert over, (numbers, c.limits)


def _alter_correspondences(monkeypatch):
    """The matching heads' correspondence logits, from which the poses
    are solved, altered where they are produced: the poses move with
    them."""
    from sam6d_tpu_torch.models.pem import matching

    sim = matching.compute_feature_similarity
    monkeypatch.setattr(matching, "compute_feature_similarity",
                        lambda *a, **k: sim(*a, **k) * 1.05)


def _alter_final_pose(monkeypatch):
    """The final pose altered after its solve, where `infer`'s answer is
    produced: the fine solve's rotation turned by one degree about z."""
    from sam6d_tpu_torch.models.pem import matching

    solve = matching.compute_fine_Rt
    a = torch.deg2rad(torch.tensor(1.0))
    turn = torch.tensor([[torch.cos(a), -torch.sin(a), 0.0],
                         [torch.sin(a), torch.cos(a), 0.0],
                         [0.0, 0.0, 1.0]])

    def broken(*args, **kw):
        R, t, score = solve(*args, **kw)
        return turn.to(R) @ R, t, score

    monkeypatch.setattr(matching, "compute_fine_Rt", broken)


def _transpose_hypotheses(monkeypatch):
    """The coarse stage's hypothesis solve broken where it is produced:
    each three-point Procrustes returns its rotation transposed."""
    from sam6d_tpu_torch.models.pem import matching

    solve = matching.weighted_procrustes

    def broken(src, ref, *args, **kw):
        R, t = solve(src, ref, *args, **kw)
        return (R.transpose(-1, -2), t) if src.shape[-2] == 3 else (R, t)

    monkeypatch.setattr(matching, "weighted_procrustes", broken)


def _half_batch_pem(monkeypatch):
    from sam6d_tpu_torch.models.pem import model

    fwd = model.PEM.forward_with_bank

    def broken(self, pts, rgb, rgb_choose, model_pts, bank, **k):
        n = max(1, len(pts) // 2)  # the first half, repeated
        idx = torch.arange(len(pts)) % n
        return fwd(self, pts[idx], rgb[idx], rgb_choose[idx],
                   model_pts[idx], bank, **k)

    monkeypatch.setattr(model.PEM, "forward_with_bank", broken)


@pytest.mark.parametrize("fault", ["answer", "half_batch", "final_pose",
                                   "coarse_solve"])
def test_the_pem_timed_path_broken_is_not_correct(monkeypatch, fault):
    if fault == "answer":
        _alter_correspondences(monkeypatch)
        rec = tiny.run("pem_base.bin")
    elif fault == "final_pose":
        _alter_final_pose(monkeypatch)
        rec = tiny.run("pem_base.bin")
    elif fault == "coarse_solve":
        _transpose_hypotheses(monkeypatch)
        rec = tiny.run("pem_base.bin")
    else:
        _half_batch_pem(monkeypatch)
        rec = tiny.run("pem_base.bin")
    assert not rec.correct, rec.numbers


@pytest.mark.parametrize("fault", ["answer", "half_batch"])
def test_the_ism_timed_path_broken_is_not_correct(monkeypatch, fault):
    from sam6d_tpu_torch.models.ism import detector, dinov2

    if fault == "answer":
        final = detector.scoring.final_score
        monkeypatch.setattr(detector.scoring, "final_score",
                            lambda *a: final(*a) * 0.8 + 0.1)
    else:
        desc = dinov2.DescriptorModel.compute_cls_and_patch

        def broken(self, images, masks):
            n = max(1, len(images) // 2)
            idx = torch.arange(len(images)) % n
            return desc(self, images[idx], masks[idx])

        monkeypatch.setattr(dinov2.DescriptorModel, "compute_cls_and_patch",
                            broken)
    rec = tiny.run("ism_sam_h.frame")
    assert not rec.correct, rec.numbers


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer"])
def test_the_training_step_broken_is_not_correct(monkeypatch, fault):
    from sam6d_tpu_torch.train import state

    if fault == "state_unchanged":
        monkeypatch.setattr(state.Optimizer, "_update",
                            lambda self, grads, gnorm: False)
    elif fault == "half_batch":
        loss = state.pem_loss

        def broken(out, gt_r, gt_t, *a):
            n = len(gt_r) // 2
            half = {k: (v[:n] if torch.is_tensor(v) and v.dim() and
                        len(v) == len(gt_r) else
                        [x[:n] for x in v] if isinstance(v, list) else v)
                    for k, v in out.items()}
            return loss(half, gt_r[:n], gt_t[:n], *a)

        monkeypatch.setattr(state, "pem_loss", broken)
    else:  # the loss the step reports, altered where it is produced
        loss = state.pem_loss

        def broken(*a):
            value, metrics = loss(*a)
            return value, dict(metrics, loss=metrics["loss"] * 1.1)

        monkeypatch.setattr(state, "pem_loss", broken)
    rec = tiny.run("pem_base.train28")
    assert not rec.correct, rec.numbers
