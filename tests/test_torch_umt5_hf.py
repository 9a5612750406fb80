"""Port parity: umt5 from ``transformers``' ``UMT5EncoderModel`` through the
port's converter (``weights/wan_convert.py``), in HuggingFace's layout and
in Wan's: the port's ``state_dict`` equals the JAX converter's carried
through ``weights.from_jax`` bit for bit, and the port's f32 T5Encoder
matches the HuggingFace model on the valid tokens within atol and rtol 2e-3
(the tolerance of tests/test_wan_torch_parity.py)."""

import numpy as np
import pytest
import torch

from infinicube_tpu.weights import wan_convert as jwan
from infinicube_tpu_torch.models.wan.t5 import T5Config, T5Encoder
from infinicube_tpu_torch.weights import wan_convert as twan
from infinicube_tpu_torch.weights.from_jax import t5_from_jax
from tests.test_torch_gsm import one_torch_thread  # noqa: F401
from torch_mirrors.umt5_keys import to_wan

transformers = pytest.importorskip("transformers")


@pytest.fixture(scope="module")
def hf_model():
    torch.manual_seed(0)
    return transformers.UMT5EncoderModel(transformers.UMT5Config(
        vocab_size=512, d_model=64, d_ff=128, num_layers=2, num_heads=4,
        d_kv=16, relative_attention_num_buckets=32,
        relative_attention_max_distance=128, feed_forward_proj="gated-gelu",
        dropout_rate=0.0, is_encoder_decoder=False, use_cache=False)).eval()


@pytest.mark.parametrize("layout", ["hf", "wan"])
def test_converted_umt5_matches_transformers(hf_model, layout):
    hsd = hf_model.state_dict()
    sd = hsd if layout == "hf" else to_wan(hsd)
    got = twan.umt5_state_dict(dict(sd), layout)
    conv = {"wan": jwan.convert_umt5_wan, "hf": jwan.convert_umt5_hf}[layout]
    want = t5_from_jax(conv(sd, 2))
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)

    model = T5Encoder(T5Config.tiny(dtype=torch.float32), device="cpu").eval()
    model.load_state_dict(got)
    ids = np.array([[5, 9, 200, 3, 1, 0, 0]], np.int64)
    mask = ids != 0
    with torch.no_grad():
        ref = hf_model(input_ids=torch.from_numpy(ids),
                       attention_mask=torch.from_numpy(mask.astype(np.int64))
                       ).last_hidden_state.numpy()
        out = model(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    # the port zeroes masked positions; compare the valid tokens
    np.testing.assert_allclose(out[mask], ref[mask], atol=2e-3, rtol=2e-3)
    assert not out[~mask].any()
