"""The plain reference against the system under test at a CPU's size,
both in float32: what the reference computes is what the program is meant
to compute.  Each tolerance sits far below what bfloat16 gives (PERF.md
lists the readings), and above float32's differences: the two sides
compute the crop's weights and the color jitter in another order (the
views differ by up to 6e-5), which the steps carry through."""
import numpy as np
import pytest
import torch

from conftest import tiny


@pytest.mark.parametrize("cell", ["rn50.train.b4096", "vit_b16.train.b256"])
def test_training_steps_agree_in_float32(cell):
    """At the learning rate of batch 4096 (6.4 x 8 / 256): at batch 8's own
    the EMA target moves by about one float32 step of its weights, and
    rounding alone sets its gap."""
    from drivers import train as drv
    from harness import checks
    from harness.spans import OFF
    conf = tiny(cell, "--no-half")
    lr = conf["flags"].index("--lr") + 1
    conf["flags"][lr] = "6.4"
    conf["optimizer"]["lr"] = 6.4
    cpu = torch.device("cpu")
    data = drv.inputs(conf, 2 ** 31 + 11, cpu)
    state, step = drv.build_program(conf, 2 ** 31 + 11, cpu, data, OFF)
    prog = drv.first_steps(state, step, data, 2, OFF)
    ref = drv.reference_readings(conf, 2 ** 31 + 11, cpu, data, 2)
    r = checks.train_readings(prog, ref)
    assert r["loss_gap"] < 1e-5
    assert r["grad_gap"] < 5e-3
    assert r["change_gap"] < 5e-3
    for buffer in ("target", "polyak", "momentum"):
        assert r[f"{buffer}_gap"] < 5e-3


def test_served_embeddings_agree_in_float32():
    from drivers import serve as drv
    from harness.spans import OFF
    conf = tiny("vit_b16.serve.poisson", "--no-half")
    conf["traffic"]["flags"] = ["--attn-impl", "dense"]
    out = drv.run(conf, 7, 1.0, False, torch.device("cpu"), OFF)
    assert out["failed"] == 0 and out["attempted"] == 20
    assert out["readings"]["embed_gap"] < 1e-4


def test_a_saturated_sender_waits_for_room():
    """Offered far above what the service answers, a request that finds
    the queue full waits for room: nothing is refused, the sender sends
    nothing once the window has closed, and every answer is right."""
    from drivers import serve as drv
    from harness.spans import OFF
    conf = tiny("vit_b16.serve.poisson", "--no-half")
    conf["traffic"]["flags"] = ["--attn-impl", "dense"]
    conf["traffic"]["serve_config"]["max_queue"] = 16
    conf["cell"]["rate_per_s"] = 50000.0
    out = drv.run(conf, 7, 2.0, False, torch.device("cpu"), OFF)
    assert out["failed"] == 0
    assert 16 < out["attempted"] < 100000
    assert out["e2e"]["serve_img_s"] * 2.0 <= out["attempted"]
    assert out["readings"]["embed_gap"] < 1e-4


def test_views_agree_with_the_programs():
    from byol_tpu_torch.data import device_augment as da
    from byol_tpu_torch.ops import fused_augment as fa
    from reference import augment
    gen = torch.Generator().manual_seed(3)
    images = torch.randint(0, 256, (8, 224, 224, 3), dtype=torch.uint8,
                           generator=gen)
    draws = augment.draw_views(gen, 8, 224, 224)
    prog = fa.fused_two_view(images, 224, [da.ViewParams(*d) for d in draws])
    for p, d in zip(prog, draws):
        ref = augment.view(images, d, 224)
        assert np.abs((p - ref).numpy()).max() < 1e-4
