"""One rank of the port's multi-rank tests on the CPU (gloo).

    python torch_parallel_worker.py RANK WORLD PORT DIR SCENARIO[,...]

Joins a gloo group of WORLD processes through
`parallel.distributed.init_distributed` (torchrun's variables, set here),
reads the inputs the test wrote to DIR/inputs.pkl, runs each named
scenario and writes its result to DIR/<scenario>_<rank>.pkl.  Imports the
port and numpy only (no JAX), so a rank starts in a few seconds.
"""

from __future__ import annotations

import os
import pickle
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from sam6d_tpu_torch.parallel.distributed import (  # noqa: E402
    init_distributed,
    sync_hosts,
)
from sam6d_tpu_torch.parallel.mesh import axis_index, make_mesh  # noqa: E402


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def hyp(inp):
    """sharded_compute_coarse_Rt on a ("hyp",) or ("dp", "hyp") mesh; the
    rank's rows and its hyp index's uniforms."""
    from sam6d_tpu_torch.parallel.hyp_parallel import (
        sharded_compute_coarse_Rt,
    )

    mesh = make_mesh(inp["shape"], inp["axes"], "cpu")
    dp = inp["shape"][0] if "dp" in inp["axes"] else 1
    B = len(inp["atten"])
    per = B // dp
    i = axis_index(mesh, "dp") if "dp" in inp["axes"] else 0
    rows = slice(i * per, (i + 1) * per)
    d = axis_index(mesh, "hyp")
    R, t = sharded_compute_coarse_Rt(
        mesh, "hyp", _t(inp["atten"][rows]), _t(inp["pts1"][rows]),
        _t(inp["pts2"][rows]), _t(inp["model"][rows]),
        n_proposal1=inp["n1"], n_proposal2=inp["n2"],
        dist_field=_t(inp["field"]), n_refine=inp["n_refine"],
        uniforms=tuple(_t(u) for u in inp["uniforms"][d]))
    return dict(rows=(rows.start, rows.stop), R=R.numpy(), t=t.numpy())


def runner(inp):
    """MeshPEMRunner: the frame's poses, on every rank."""
    from sam6d_tpu_torch.parallel.pem_serving import MeshPEMRunner

    mesh = make_mesh(inp["shape"], inp["axes"], "cpu")
    run = MeshPEMRunner(inp["cfg"], mesh, state_dict={
        k: _t(v) for k, v in inp["state"].items()}, device="cpu")
    run.make_template_bank(_t(inp["tem_pts"]), _t(inp["tem_feat"]))
    u = inp["uniforms"]
    if "hyp" in inp["axes"]:
        u = u[axis_index(mesh, "hyp")]
    out = run.infer(dict(inp["inst"]), uniforms=u)
    return dict(out, bucket=run.bucket_for(len(inp["inst"]["pts"])))


def merge(inp):
    """write_shard_and_merge with a rank 1 that writes late."""
    from sam6d_tpu_torch.pipeline.bop_eval import write_shard_and_merge

    rank = torch.distributed.get_rank()
    if rank == 1:
        time.sleep(inp["delay_s"])
    rows = [{"rank": rank, "row": j} for j in range(rank + 1)]
    merged = write_shard_and_merge(inp["dir"], rows, prefix="pem_shard",
                                   merged_name="merged.json")
    return dict(merged=merged)


def train(inp, tp: int):
    """One train_step on a (world / tp, tp) mesh, from the global batch;
    the gathered parameters and BatchNorm statistics."""
    from sam6d_tpu_torch.parallel.sharding import (
        shard_train_state,
        unsharded_state_dict,
    )
    from sam6d_tpu_torch.train.state import create_train_state, train_step

    world = torch.distributed.get_world_size()
    mesh = make_mesh((world // tp, tp), ("dp", "tp"), "cpu")
    state = create_train_state(inp["cfg"], inp["optim"], device="cpu",
                               state_dict={k: _t(v) for k, v in
                                           inp["state"].items()})
    shard_train_state(state, mesh)
    metrics = train_step(state, inp["batch"],
                         generator=torch.Generator().manual_seed(inp["seed"]))
    full = unsharded_state_dict(state.model)
    return dict(metrics=metrics,
                state={k: v.numpy() for k, v in full.items()})


def cli(inp):
    """`train_cli.main` at the tiny config over the ranks as (dp, tp) =
    (world / 2, 2), then `save_params` of the sharded model."""
    from sam6d_tpu_torch.train import train_cli
    from sam6d_tpu_torch.train.checkpoint import save_params

    train_cli.PEMConfig = lambda: inp["cfg"]
    train_cli.TrainConfig = lambda: inp["train_cfg"]
    solver = train_cli.main([
        "--synthetic", "--steps", "2", "--epochs", "1", "--tp", "2",
        "--device", "cpu", "--log_dir", inp["log_dir"]])
    path = save_params(inp["params"], solver.state.model)
    par = solver.state.parallel
    return dict(step=solver.state.step, path=path, dp=par.dp, tp=par.tp,
                tp_index=par.tp_index)


def mesh(inp):
    """make_mesh's shape check and global_mesh's layout."""
    from sam6d_tpu_torch.parallel.distributed import global_mesh

    try:
        make_mesh((3,), ("dp",), "cpu")
        error = None
    except ValueError as e:
        error = str(e)
    m = global_mesh(tp=2, device_type="cpu")
    return dict(error=error, names=m.mesh_dim_names,
                shape=tuple(m.mesh.shape))


def bop(inp):
    """The PEM sweep over two ranks, merged on rank 0."""
    from sam6d_tpu_torch.pipeline.bop_eval import run_bop_eval
    from sam6d_tpu_torch.pipeline.pem_runner import PEMRunner

    run = PEMRunner(inp["cfg"], state_dict={k: _t(v) for k, v in
                                            inp["state"].items()},
                    device="cpu")
    u = inp["uniforms"]
    rows = run_bop_eval(inp["cfg"], inp["root"], inp["det_path"],
                        inp["templates"], inp["out"], runner=run,
                        uniforms=lambda bucket: u[bucket], device="cpu")
    return dict(rows=rows)


SCENARIOS = {"hyp": hyp, "runner": runner, "merge": merge,
             "train_dp": lambda inp: train(inp, 1),
             "train_tp": lambda inp: train(inp, 2), "cli": cli, "mesh": mesh,
             "bop": bop}


def main():
    rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], Path(sys.argv[4]))
    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                      WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    assert init_distributed(device="cpu")
    with open(out / "inputs.pkl", "rb") as f:
        inputs = pickle.load(f)
    for name in sys.argv[5].split(","):
        scenario = name.split(":")[0]
        result = SCENARIOS[scenario](inputs[name])
        with open(out / f"{name}_{rank}.pkl", "wb") as f:
            pickle.dump(result, f)
        sync_hosts(name)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
