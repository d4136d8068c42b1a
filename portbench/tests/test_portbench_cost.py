"""The frozen cost and model-FLOP arithmetic against hand counts."""
import pytest
import smoke  # noqa: F401

import cost
import flops
import harness


def test_paged_decode_counts_attended_positions_and_pages():
    # q (B 2, H 4, hd 8); pages (5, ps 4, KVH 2, hd 8); lengths 3 and 6
    call = {"shapes": [(2, 4, 8), (5, 4, 2, 8)], "dtype_bytes": 2,
            "positions": 9, "lengths_list": [3, 6]}
    flops_ = 4 * 9 * 4 * 8                      # QK^T and PV
    nbytes = 2 * 9 * 2 * 8 * 2 + 2 * 2 * 4 * 8 * 2 + 4 * 2 + 4 * 3
    assert (flops_, nbytes) == (1152, 852)
    assert cost.paged_decode(call) == pytest.approx(
        max(1152 / 989e12, 852 / 3.35e12))


def test_moe_gmm_counts_live_experts_and_filled_rows():
    call = {"shapes": [(4, 3, 16), (4, 16, 8)], "dtype_bytes": 2,
            "live": 3, "rows": 5}
    # 3 experts' weights, 5 rows of x, 5 rows of the (4, 3, 8) output
    assert cost.moe_gmm(call) == pytest.approx(
        max(2 * 5 * 16 * 8 / 989e12, 2 * (384 + 80 + 40) / 3.35e12))
    whole = dict(call)
    del whole["live"], whole["rows"]
    assert cost.moe_gmm(whole) == pytest.approx(
        max(2 * 12 * 16 * 8 / 989e12, 2 * (512 + 192 + 96) / 3.35e12))


def test_flash_counts_the_causal_pairs():
    call = {"shapes": [(2, 4, 8), (2, 4, 8), (2, 4, 8)], "dtype_bytes": 2}
    assert cost.flash(call) == pytest.approx(
        max(4 * 2 * 8 * 10 / 989e12, 2 * 2 * 8 * 8 * 2 / 3.35e12))
    fp32 = dict(call, dtype_bytes=4)
    assert cost.flash(fp32) == pytest.approx(
        max(640 / 67e12, 1024 / 3.35e12))


def test_roofline_share_and_nothing_to_read():
    call = {"shapes": [(4, 3, 16), (4, 16, 8)], "dtype_bytes": 2}
    b = cost.moe_gmm(call)
    rec = {"trace": {"ops": {"gmm": [2 * b, 2 * b]}},
           "calls": {"gmm": [call, call]}}
    assert cost.roofline(rec, "gmm", cost.moe_gmm) == pytest.approx(50.0)
    assert cost.roofline(rec, "paged_decode", cost.paged_decode) is None
    assert cost.roofline({"trace": None}, "gmm", cost.moe_gmm) is None


def test_model_flops_by_hand():
    m = harness.load_json(harness.HERE / "configs"
                          / "musicgen-large.json")["model"]
    emb = 8 * 2048 * 2048            # 1 + 4 heads' tables, 3 more embeds
    layer = (2048 * (2048 + 2 * 2048) + 2048 * 2048 + 2 * 2048
             + 3 * 2048 * 8192)
    assert flops.param_count(m) == emb + 48 * layer == 3_254_976_512
    assert flops.serve_flops(m, 10) == 2.0 * 3_254_976_512 * 10
    assert flops.train_flops(m, 10) == 6.0 * 3_254_976_512 * 10


@pytest.mark.parametrize("config", ["musicgen-large", "arctic-480b-2l"])
def test_model_flops_match_the_ports_count_at_freezing(config):
    import dataclasses

    from repro_torch.configs import get_config
    f = harness.load_json(harness.HERE / "configs" / f"{config}.json")
    cfg = dataclasses.replace(get_config(f["arch"]), **f["model"])
    for active in (False, True):
        assert flops.param_count(f["model"], active) == \
            cfg.param_count(active=active)
