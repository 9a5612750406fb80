"""Port parity: ``infinicube_tpu_torch.utils.profiling`` and
``utils/common.py`` against their JAX counterparts (``tests/test_misc_utils.py``
and ``tests/test_parity_utils.py`` hold those). ``mask_image_patches`` with
JAX's own uniform draws gives JAX's image exactly; the trace is written only
when ``PT_PROFILE`` is set."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinicube_tpu.utils import profiling as jprof
from infinicube_tpu.utils.common import mask_image_patches as jax_mask
from infinicube_tpu_torch.config import ConfigArgumentParser
from infinicube_tpu_torch.utils import common, profiling
from tests.test_torch_gsm import one_torch_thread  # noqa: F401
from tests.test_torch_training import TINY


def test_profile_named_writes_a_trace_only_when_asked(tmp_path, monkeypatch):
    monkeypatch.delenv("PT_PROFILE", raising=False)
    with profiling.profile_named("off", logdir=str(tmp_path)):
        torch.ones(3).sum()
    assert not list(tmp_path.iterdir())
    monkeypatch.setenv("PT_PROFILE", "1")
    with profiling.profile_named("on", logdir=str(tmp_path)):
        with profiling.annotate("region"):
            torch.ones(3).sum()
    trace = (tmp_path / "on.json").read_text()
    assert '"region"' in trace


def test_mem_profile_prints_nothing_without_a_card(monkeypatch, capsys):
    monkeypatch.setenv("MEM_PROFILE", "1")

    @profiling.mem_profile()
    def f(x):
        return x + 1

    assert f(1) == 2
    if not torch.cuda.is_available():
        assert capsys.readouterr().out == ""


def test_timers_and_meters_match_jax():
    t = profiling.Timer()
    x = torch.ones(2)
    assert profiling.Timer.fence(x) is x
    assert t.elapsed() >= 0.0
    tc, jtc = profiling.TimerCollection(), jprof.TimerCollection()
    for c in (tc, jtc):
        for _ in range(2):
            with c.time("a"):
                pass
    assert {k: v["count"] for k, v in tc.report().items()} == \
        {k: v["count"] for k, v in jtc.report().items()} == {"a": 2}
    meters = [(profiling.AverageMeter(), jprof.AverageMeter()),
              (profiling.RunningAverageMeter(0.5),
               jprof.RunningAverageMeter(0.5))]
    for a, b in meters:
        for v in (1.0, 3.0, 2.5):
            a.update(v)
            b.update(v)
    (a, b), (ra, rb) = meters
    assert (a.avg, a.sum, a.count) == (b.avg, b.sum, b.count)
    assert ra.val == rb.val == 2.5 * 0.5 + 0.5 * (0.5 * 1.0 + 0.5 * 3.0)


@pytest.mark.parametrize("shape,patch,p", [((2, 64, 64, 3), 16, 0.5),
                                           ((3, 50, 70, 1), 32, 0.3)])
def test_mask_image_patches_matches_jax(shape, patch, p):
    img = np.random.default_rng(0).uniform(size=shape).astype(np.float32)
    key = jax.random.PRNGKey(3)
    ref = np.asarray(jax_mask(key, jnp.asarray(img), patch=patch,
                              drop_prob=p))
    h, w = shape[1:3]
    grid = shape[:1] + (-(-h // patch), -(-w // patch))
    draws = torch.from_numpy(np.asarray(jax.random.uniform(key, grid)))
    out = common.mask_image_patches(torch.from_numpy(img), patch, p,
                                    draws=draws)
    np.testing.assert_array_equal(out.numpy(), ref)
    # from a generator: whole patches are dropped together
    g = torch.Generator().manual_seed(0)
    o = common.mask_image_patches(torch.ones(shape), patch, p, generator=g)
    assert ((o == 0) | (o == 1)).all() and 0 < float((o == 0).float().mean())
    with pytest.raises(ValueError, match="draws of shape"):
        common.mask_image_patches(torch.ones(shape), patch, p,
                                  draws=torch.zeros(3))


def test_create_model_and_batch2device():
    cfg = ConfigArgumentParser().parse_config(["none", "--exec", *TINY])
    params, loss_fn = common.create_model_from_config(cfg, device="cpu")
    assert params and all(p.device.type == "cpu" for p in params.values())
    batch = {"a": torch.ones(2), "b": (torch.zeros(1), "label")}
    out = common.batch2device(batch, "cpu")
    assert torch.equal(out["a"], batch["a"]) and out["b"][1] == "label"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            common.batch2device(batch)
