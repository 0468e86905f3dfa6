"""The cells at tiny sizes, for the benchmark's tests on the CPU: the
cells' own files (config, traffic, limits) with the networks' widths,
the batch and the frame and pool sizes cut, float32 compute."""

from __future__ import annotations

import dataclasses

from portbench.harness import cells

PEM = {"coarse_npoint": 32, "fine_npoint": 128,
       "feature_extraction": {"embed_dim": 64, "depth": 4, "num_heads": 4,
                              "out_dim": 32, "img_size": 32,
                              "patch_size": 8},
       "geo_embedding": {"hidden_dim": 32},
       "coarse_point_matching": {"input_dim": 32, "hidden_dim": 32,
                                 "out_dim": 32, "nproposal1": 64,
                                 "nproposal2": 16},
       "fine_point_matching": {"input_dim": 32, "hidden_dim": 32,
                               "out_dim": 32},
       "n_template_view": 4, "n_sample_template_point": 200,
       "n_sample_model_point": 64, "n_sample_observed_point": 128}


def cell(name: str) -> cells.Cell:
    c = cells.resolve(name)
    conf, tr = dict(c.config), dict(c.traffic)
    conf["compute_dtype"] = "float32"
    if tr["driver"] in ("pem_serve", "pem_train"):
        conf["pem"] = PEM
        conf["train"] = dict(conf["train"], batch_size=4, img_size=32,
                             n_sample_observed_point=128,
                             n_sample_template_point=200)
    if tr["driver"] == "pem_serve":
        tr.update(pool_instances=14, frames=min(tr["frames"], 12),
                  check_among=min(tr["check_among"], 12))
    if tr["driver"] == "ism_serve":
        ism = dict(conf["ism"])
        ism["segmentor"] = dict(ism["segmentor"], model_type="vit_b",
                                points_per_side=8, points_per_batch=16)
        ism["descriptor"] = dict(ism["descriptor"], embed_dim=64, depth=2,
                                 num_heads=4, image_size=56)
        conf.update(ism=ism, img_size=256, encoder_kwargs={
            "embed_dim": 64, "depth": 2, "num_heads": 4,
            "global_attn_indexes": (1,), "window_size": 4})
        tr.update(objects=2, template_views=4, frames=3, warm_frames=1,
                  check_frames=2, check_among=3, trace_frames=3)
    return dataclasses.replace(c, config=conf, traffic=tr)


def run(name: str, seed: int = 2 ** 33 + 17, seconds: float = 2.0):
    """One run of the tiny cell on the CPU (no trace), as the harness
    drives it after its look for a card."""
    import time

    c = cell(name)
    driver = cells.load_driver(c.traffic["driver"])
    return driver.run(c, seed, seconds, False, time.perf_counter(),
                      device="cpu")
