"""Linear-eval extraction over the data axis
(``training/linear_eval.py::extract_features_spmd``), held against the
port's one-rank extraction, which tests/test_torch_linear_eval.py holds
against the JAX package.

Two ranks (OS processes over gloo, tests/torch_ranks.py) extract the
resize-only features of the fake task's train split (each its contiguous
shard) and test split (whole on every rank, its batches dealt
round-robin), in lockstep, all-gathered.  They must equal one rank's
extraction row for row (labels exactly, features at 1e-5: the ranks run
batches of half the rows), and the probe fitted on them its W and b at
1e-4, on both ranks alike; ``run_linear_eval_from_cfg`` runs on every
rank (no refusal) and scores as one rank does.
"""
import numpy as np

from tests.torch_ranks import linear_eval, run_ranks
from tests.torch_ranks import one_torch_thread  # noqa: F401

ARGV = ["--no-cuda", "--task", "fake", "--arch", "resnet18",
        "--image-size-override", "16", "--batch-size", "64", "--no-half",
        "--head-latent-size", "32", "--projection-size", "16",
        "--workers-per-replica", "0"]


def test_two_rank_extraction_equals_one_rank(tmp_path):
    spec = dict(argv=ARGV, epochs=5)
    ranks = run_ranks("linear_eval", spec, 2, tmp_path)
    one = linear_eval(spec)                  # no process group: one rank
    for r in ranks:
        for split in ("train", "test"):
            (fx, fy), (wx, wy) = r[split], one[split]
            assert fx.shape == wx.shape and len(fy) == len(wy) > 0
            assert np.array_equal(fy, wy), split
            np.testing.assert_allclose(fx, wx, rtol=1e-5, atol=1e-5,
                                       err_msg=split)
        for got, want in zip(r["probe"], one["probe"]):
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        assert (r["result"].num_train, r["result"].num_test) == (
            one["result"].num_train, one["result"].num_test)
        assert r["result"].top1 == one["result"].top1
    for a, b in zip(ranks[0]["probe"], ranks[1]["probe"]):
        assert np.array_equal(a, b)
