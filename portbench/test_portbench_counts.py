"""The FLOP and byte counts of the per-layer readers against values
worked out by hand from the published widths."""
import math

import pytest

from portbench import harness
from portbench.spec import model_spec

MINICPM = model_spec(harness.load_json(harness.HERE / "configs"
                                       / "minicpm-2b.json"))
GRANITE = model_spec(harness.load_json(harness.HERE / "configs"
                                       / "granite-moe-3b-a800m.json"))


reader = harness.reader


def test_minicpm_matmul_parameters():
    # a layer: q, k, v, o 4 x 2304 x 2304 = 21,233,664; SwiGLU 3 x 2304 x
    # 5760 = 39,813,120; 40 layers 2,441,871,360; head 2304 x 122,753 =
    # 282,822,912
    assert reader("mfu.train").matmul_params(MINICPM) == 2_724_694_272


def test_minicpm_train_step_flops():
    # 6 x 2,724,694,272 x 2,048 = 33,481,043,214,336; attention 40 x 4 x 2
    # x 512^2 x 64 x 36 = 193,273,528,320, three times 579,820,584,960
    assert reader("mfu.train").step_flops(MINICPM, 4, 512) \
        == 34_060_863_799_296
    # one row of 4,096: 66,955,236,139,008 + 3 x 3,092,376,453,120
    assert reader("mfu.train").step_flops(MINICPM, 1, 4096) \
        == 76_239_215_788_032


def test_granite_active_body_parameters():
    # a layer: q, o 2 x 1536 x 1536 = 4,718,592; k, v 2 x 1536 x 512 =
    # 1,572,864; 8 experts x 3 x 1536 x 512 = 18,874,368; router 1536 x
    # 40 = 61,440; 32 layers
    assert reader("mfu.prefill").body_params(GRANITE) == 807_272_448


def test_prefill_batch_flops():
    # granite, 8 x 4,096: 2 x 807,272,448 x 32,768 = 52,905,407,152,128;
    # head once a prompt 2 x 1536 x 49,155 x 8 = 1,208,033,280; attention
    # 32 x 8 x 2 x 4096^2 x 64 x 24 = 13,194,139,533,312
    assert reader("mfu.prefill").batch_flops(GRANITE, 8, 4096) \
        == 66_100_754_718_720
    # minicpm: 2 x 2,441,871,360 x 32,768 + 2 x 2304 x 122,753 x 8 + 40 x
    # 8 x 2 x 4096^2 x 64 x 36
    assert reader("mfu.prefill").batch_flops(MINICPM, 8, 4096) \
        == 184_774_018_240_512


def test_flash_bounds():
    # forward, h=36, s=4096, d=64: 2 x 4096^2 x 64 x 36 = 7.73e10 FLOPs
    # over 495e12 = 0.15617 ms; bytes 16 x 36 x 4096 x 64 = 151 MB over
    # 3.35e12 = 0.04507 ms
    fwd = reader("flash_fwd_roofline.prefill").layer_bound_s(1, 36, 4096, 64)
    assert math.isclose(fwd, 2 * 4096 ** 2 * 64 * 36 / 495e12)
    # backward at 4 x 36 heads, s=512: FLOPs 5 x 512^2 x 64 x 144 = 1.21e10
    # (24.4 us); bytes 4 x (8 x 144 x 512 x 64 + 144 x 512) = 151.3 MB
    # (45.2 us): bound by the bytes
    bwd = reader("flash_bwd_roofline.train").layer_bound_s(4, 36, 512, 64)
    assert math.isclose(bwd, 4 * (8 * 144 * 512 * 64 + 144 * 512) / 3.35e12)


@pytest.mark.parametrize("name", ["mfu.train", "mfu.prefill"])
def test_mfu_is_a_share_of_the_bf16_peak(name):
    import types
    w = {"seconds": 2.0, "units": [{"batch": 4, "seq": 512}] * 3}
    kind = name.split(".")[1]
    ctx = types.SimpleNamespace(trace=None, spec=MINICPM, mix={"kind": kind},
                                window=w)
    mod = reader(name)
    per = (mod.step_flops if name == "mfu.train" else mod.batch_flops)(
        MINICPM, 4, 512)
    assert math.isclose(mod.read(ctx), 100 * 3 * per / (2.0 * 989e12))
    ctx.window = {"seconds": 2.0, "units": []}
    assert mod.read(ctx) is None
