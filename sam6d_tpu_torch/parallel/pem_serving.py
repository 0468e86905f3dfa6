"""PEM serving on a mesh: a frame's instances split over the `dp` axis,
the coarse hypotheses over `hyp` (the mesh branch of `sam6d_tpu/
pipeline/pem_runner.py`).  Weights and template bank are replicated;
every rank calls `infer` with the same frame and returns all of it."""

import torch

from sam6d_tpu_torch.parallel.collectives import all_gather_rows
from sam6d_tpu_torch.parallel.hyp_parallel import sharded_compute_coarse_Rt
from sam6d_tpu_torch.parallel.mesh import (DP, HYP, axis_group, axis_index,
                                           axis_size, has_axis)
from sam6d_tpu_torch.pipeline import pem_runner
from sam6d_tpu_torch.utils.timer import stage


class MeshPEMRunner(pem_runner.PEMRunner):
    def __init__(self, cfg, mesh, **kwargs):
        """mesh: a DeviceMesh (`parallel.make_mesh`); kwargs: `PEMRunner`'s.
        A "dp" axis gives each rank one slice of the bucket, gathered back;
        a "hyp" axis spreads the coarse solve (`sharded_compute_coarse_Rt`).
        `infer`'s uniforms: with a hyp axis this rank's (`hyp_parallel.
        local_budget`), alike across dp as the JAX solve's folded key;
        else the bucket's, drawn bucket-wide on a dp axis when not given
        (as under the JAX runner's jit), each rank taking its rows."""
        super().__init__(cfg, **kwargs)
        self.mesh = mesh
        self.dp = axis_size(mesh, DP)

    def bucket_for(self, n: int) -> int:
        """dp times the one-device bucket of a rank's share of
        min(n, max_bucket): a power of two times dp, at least dp."""
        share = -(-min(n, self.max_bucket or n) // self.dp)
        return self.dp * super().bucket_for(share)

    def _solve(self, atten, p1, p2, norm_model, dist_field, uniforms,
               generator):
        c = self.cfg.coarse_point_matching
        return sharded_compute_coarse_Rt(
            self.mesh, HYP, atten, p1, p2, norm_model,
            n_proposal1=c.nproposal1, n_proposal2=c.nproposal2,
            dist_field=dist_field, uniforms=uniforms, generator=generator)

    def _pose_chunk(self, input_data, lo, hi, bucket, uniforms):
        per = bucket // self.dp
        first = axis_index(self.mesh, DP) * per
        rows = slice(first, first + per)
        solver = self._solve if has_axis(self.mesh, HYP) else None
        if solver is None and uniforms is not None:
            uniforms = tuple(u[rows] for u in uniforms)
        elif solver is None and has_axis(self.mesh, DP):
            shape = (bucket, 3 * self.cfg.coarse_point_matching.nproposal1, 1)
            uniforms = tuple(torch.rand(shape, generator=self.generator,
                                        device=self.device)[rows]
                             for _ in range(2))
        with stage(None, "pem_runner.upload"):
            args = [torch.as_tensor(
                pem_runner.padded_chunk(input_data[k], lo, hi, bucket)[rows],
                device=self.device, dtype=dtype)
                for k, dtype in pem_runner.INPUTS]
        with stage(None, "pem.forward"):
            out = self.model.forward_with_bank(
                *args, self.template_bank, generator=self.generator,
                uniforms=uniforms, coarse_solver=solver)
        with stage(None, "pem_runner.download"):
            res = [out[k].float() for k in pem_runner.POSES]
            if has_axis(self.mesh, DP):
                group = axis_group(self.mesh, DP)
                res = [all_gather_rows(r, group).flatten(0, 1) for r in res]
            return [r[:hi - lo].cpu().numpy() for r in res]
