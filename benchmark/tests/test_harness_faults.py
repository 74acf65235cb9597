"""A run whose timed path is broken underneath comes out as not correct,
and so does the control: the reference computed in float8 in the
program's place.  Each drives the rest of a run (``run.measure``: the
driver, the window, the reference, the limits of the cell's file) on the
CPU at a small size, skipping only the look for a card."""
import numpy as np
import pytest
import torch

from conftest import REPO, tiny

SEED = 2 ** 31 + 5


def _measure(conf):
    import run
    return run.measure(conf, SEED, 0.5, False, torch.device("cpu"))


def _broken_step(monkeypatch, wrap):
    from byol_tpu_torch.training import steps
    make = steps.make_train_step

    def broken(*args, **kwargs):
        return wrap(make(*args, **kwargs))

    monkeypatch.setattr(steps, "make_train_step", broken)


# each buffer the step updates, and the number that reads 1 when it is
# left unchanged: all of them together, or only the EMA target, the Polyak
# average or the momentum trace while the parameters move as they should
BUFFERS = {"all": "change_gap", "target": "target_gap",
           "polyak": "polyak_gap", "momentum": "momentum_gap"}


@pytest.mark.parametrize("buffer", list(BUFFERS))
@pytest.mark.parametrize("cell", ["rn50.train.b4096", "vit_b16.train.b256"])
def test_a_step_that_leaves_its_state_unchanged(monkeypatch, cell, buffer):
    def wrap(step):
        def unchanged(state, batch):
            bufs = ([b for b in (state.params, state.target, state.polyak,
                                 *state.opt.values()) if b is not None]
                    if buffer == "all" else [getattr(state, buffer)])
            saved = [b.clone() for b in bufs]
            metrics = step(state, batch)
            for b, s in zip(bufs, saved):
                b.copy_(s)
            return metrics
        return unchanged

    _broken_step(monkeypatch, wrap)
    result, compared = _measure(tiny(cell))
    assert result["correct"] is False
    assert compared[BUFFERS[buffer]]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", ["rn50.train.b4096", "vit_b16.train.b256"])
def test_half_of_the_batch_left_out(monkeypatch, cell):
    def wrap(step):
        def half(state, batch):
            return step(state, {k: v[:v.shape[0] // 2]
                                for k, v in batch.items()})
        return half

    _broken_step(monkeypatch, wrap)
    result, _ = _measure(tiny(cell))
    assert result["correct"] is False


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    from byol_tpu_torch.serving import engine
    readback = engine.ServingEngine.readback

    def altered(self, inflight, timeline=None):
        out = readback(self, inflight, timeline).copy()
        out[0] = -out[0]
        return out

    monkeypatch.setattr(engine.ServingEngine, "readback", altered)
    result, compared = _measure(tiny("vit_b16.serve.poisson"))
    assert result["correct"] is False
    assert compared["embed_gap"]["value"] > compared["embed_gap"]["limit"]


@pytest.mark.parametrize("cell, size", [("rn50.train.b4096", 72),
                                        ("vit_b16.train.b256", 224)])
def test_the_float8_control_fails_a_training_cell(cell, size):
    """ViT-B/16 at its own 224 px (at 32 px, 5 tokens, float8 moves the
    median leaf's gradient by a fifth of what it does at 197)."""
    from drivers import train as drv
    from harness import checks
    from reference.precision import FP8
    conf = tiny(cell)
    conf["image_size"] = size
    cpu = torch.device("cpu")
    data = drv.inputs(conf, SEED, cpu)
    n = conf["traffic"]["check_steps"]
    ref = drv.reference_readings(conf, SEED, cpu, data, n)
    ctl = drv.reference_readings(conf, SEED, cpu, data, n, cast=FP8)
    correct, _ = checks.judge(checks.train_readings(ctl, ref),
                              conf["cell"]["limits"])
    assert correct is False


def test_the_float8_control_fails_the_serving_cell():
    """At the served size (224 px: at 32 px, 5 tokens, float8 reads far
    less), over a pool of 16 images."""
    from drivers import serve as drv
    from harness import checks, registry
    from reference.precision import FP8
    conf = registry.spec(REPO, "vit_b16.serve.poisson")
    conf["traffic"]["pool"] = 16
    cpu = torch.device("cpu")
    pool = drv.pool_images(conf, SEED, cpu)
    ref = drv.reference_embeddings(conf, SEED, cpu, pool)
    ctl = drv.reference_embeddings(conf, SEED, cpu, pool, FP8)
    gap = checks.embed_gaps(ctl, np.arange(len(pool)), ref).max()
    assert gap > conf["cell"]["limits"]["embed_gap"]
