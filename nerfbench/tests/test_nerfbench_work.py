"""The work counts: chip_smoke's MFLOP a point at the published widths,
and the kernels' operations from them."""
import json
from pathlib import Path

from nerfbench import work

CFG = json.loads((Path(__file__).resolve().parents[1] / "configs" /
                  "nerf_blender_dense.json").read_text())
MODEL = CFG["model"]


def test_flops_per_point_match_the_published_widths():
    assert work.flops_per_point(MODEL, full=False) == 982_528
    assert work.flops_per_point(MODEL) == 1_186_816
    assert work.flops_per_point(MODEL, train=True) == 3_489_024


def test_param_count_is_the_mlp_of_the_reference():
    # D=8, W=256, the skip at 4, 63/27-wide embeddings, 128-wide view layer
    assert work.n_params(MODEL) == 595_844


def test_step_and_frame_work():
    step = work.train_step_work(CFG, 1024)
    assert step["mse_render"] == [(1024, 64), (1024, 128)]
    assert step["ops"] == 1024 * 192 * 3_489_024
    frame = work.frame_work(CFG, 160_000)
    assert frame["ops"] == 160_000 * (64 * 982_528 + 128 * 1_186_816)
    ops, nbytes = work.kernel_work("render_eval", MODEL, 32768, 128)
    assert ops == 32768 * 128 * 1_186_816
    # operations bound every kernel at the timed shapes
    for k, (R, S) in (("render_eval", (32768, 128)),
                      ("sigma_render", (32768, 64)),
                      ("mse_render", (1024, 32))):
        ops, nbytes = work.kernel_work(k, MODEL, R, S)
        assert ops / work.BF16_FLOPS_PER_S > nbytes / work.HBM_BYTES_PER_S
