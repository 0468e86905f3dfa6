"""The PEM serving traffic: one onboarded object, a pool of its observed
instances, and a sequence of frames drawn from the seed.

The object and its templates come from the traffic file's `object_seed`,
so that every run onboards the same object; `--seed` draws the instances'
poses, which instances each frame holds, the order of the frames and the
coarse stage's hypothesis uniforms.  Frame sizes repeat in whole cycles:
each cycle is a permutation of the traffic's `instances` list, so every
seed serves the same multiset of sizes in another order.
"""

from __future__ import annotations

import numpy as np

from portbench.harness import objects


def build(tr: dict, cfg, seed: int) -> dict:
    """tr: the traffic file; cfg: a PEMConfig (port or reference).
    Returns the template arrays, the model points and the frames, each
    frame {"n", "inputs"} with `inputs` as PEMRunner.infer takes them."""
    S = cfg.feature_extraction.img_size
    obj_rng = np.random.default_rng(tr["object_seed"])
    obj = objects.make_object(obj_rng, tuple(tr["diameter_m"]))
    tem = objects.templates(obj, S, cfg.n_sample_template_point, obj_rng,
                            cfg.n_template_view)
    model_pts = objects.sample_surface(obj, cfg.n_sample_model_point, obj_rng)
    rng = np.random.default_rng([tr["object_seed"], seed])
    pool = [objects.instance(obj, S, cfg.n_sample_observed_point, rng,
                             tuple(tr["distance_m"]), tr["depth_noise_m"])
            for _ in range(tr["pool_instances"])]
    counts = []
    while len(counts) < tr["frames"]:
        counts.extend(int(n) for n in rng.permutation(tr["instances"]))
    frames = []
    for n in counts[:tr["frames"]]:
        idx = rng.choice(len(pool), n, replace=False)
        frames.append({"n": n, "inputs": {
            "pts": np.stack([pool[i]["pts"] for i in idx]),
            "rgb": np.stack([pool[i]["rgb"] for i in idx]),
            "rgb_choose": np.stack([pool[i]["rgb_choose"] for i in idx]),
            "model_pts": np.repeat(model_pts[None], n, axis=0),
            "score": np.ones(n, np.float32),
        }})
    return {"templates": tem, "model_pts": model_pts, "frames": frames}


def uniforms(buckets, nproposal1: int, seed: int, device):
    """The coarse hypothesis uniforms (u1, u2) of each frame, each
    (bucket, 3 * nproposal1, 1), drawn on the device from the seed."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    return [tuple(torch.rand((b, 3 * nproposal1, 1), generator=g,
                             device=device) for _ in range(2))
            for b in buckets]


def check_frames(frames, count: int, among: int, seed: int) -> list[int]:
    """Indices of the frames whose served poses are judged: `count` of
    the first `among`, drawn from the seed, always with the frame of the
    most instances among them."""
    among = min(among, len(frames))
    largest = max(range(among), key=lambda i: frames[i]["n"])
    rng = np.random.default_rng([7, seed])
    rest = [i for i in rng.permutation(among) if i != largest]
    return sorted([largest] + [int(i) for i in rest[:count - 1]])


def among(tr: dict, trace: bool) -> int:
    """How many of the first frames the judged ones are drawn from: the
    traffic's `check_among`, and no more than a traced run serves."""
    return min(tr["check_among"], tr["trace_frames"]) if trace \
        else tr["check_among"]
