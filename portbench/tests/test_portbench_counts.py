"""The frozen FLOP and byte arithmetic of portbench/counts, against
values worked out by hand at small shapes."""

import math

import pytest

from portbench.counts import kernels, ops, peaks

SMALL = dict(vocab_size=10, emb_dim=3, feat_dim=8, hid_dim=4, out_dim=5,
             combined_dim=2, n_kernels=2, neighbourhood_size=2, n_obj=3)


def test_peaks_are_the_published_h100_sxm_figures():
    assert peaks.BF16_FLOPS == 989e12
    assert peaks.F32_FLOPS == 67e12
    assert peaks.HBM_BYTES == 3.35e12


def test_n_params_by_hand():
    # wembed 30; GRU 3*4*3 + 3*4*4 + 6*4 = 36 + 48 + 24 = 108;
    # edge layers 2*(8+4) + 2*2 + 2*2 + 2*2 = 24 + 4 + 4 + 4 = 36;
    # convs 8*8 + 2*4*4 + 8*2 = 64 + 32 + 16 = 112;
    # outs 5*4 + 10 + 25 + 10 = 65
    assert ops.n_params(SMALL) == 30 + 108 + 36 + 112 + 65


def test_forward_products_by_hand():
    p = {x.name: x for x in ops.products(SMALL, b=2, qsum=5)}
    # GRU input: 2 * 5 rows * 3 * 12; recurrence 2 * 5 * 4 * 12
    assert p["gru_input"].flops == 360
    assert p["gru_recurrence"].flops == 480
    # edge layer 1: 2 * B K F C + 2 * B H C = 2*2*3*8*2 + 2*2*4*2
    assert p["edge_layer_1"].flops == 192 + 32
    # conv1 projection 2 * 2 * 3 * 8 * 8; aggregation over m = 2 only
    assert p["conv1_projection"].flops == 768
    assert p["conv1_aggregation"].flops == 2 * 2 * 3 * 2 * 8
    assert p["out_2"].flops == 2 * 2 * 5 * 5
    # nodes in bf16 and the f32 weight: 2*3*8*2 + 8*8*4, out 2*3*8*2
    assert p["conv1_projection"].x_bytes == 96
    assert p["conv1_projection"].w_bytes == 256
    assert p["conv1_projection"].y_bytes == 96
    assert (p["conv1_projection"].dx, p["conv1_projection"].dw) == (False, True)


def test_model_flops_training_is_three_forwards():
    f = ops.model_flops(SMALL, 2, 5, False)
    assert f == sum(x.flops for x in ops.products(SMALL, 2, 5))
    assert ops.model_flops(SMALL, 2, 5, True) == 3 * f


def test_op_least_time_is_the_larger_bound():
    by_flops = ops.Op("a", 989e12, 1.0)
    assert by_flops.seconds() == pytest.approx(1.0)
    by_bytes = ops.Op("b", 1.0, 3.35e12)
    assert by_bytes.seconds() == pytest.approx(1.0)
    assert ops.Op("c", 67e12, 0, "f32").seconds() == pytest.approx(1.0)


def test_train_ops_hold_adam_and_each_needed_gradient():
    t = {o.name: o for o in ops.train_ops(SMALL, 2, 5)}
    assert t["adam"].nbytes == 28 * ops.n_params(SMALL)
    assert "conv1_projection.dw" in t and "conv1_projection.dx" not in t
    assert "adjacency.dx" in t and "adjacency.dw" not in t
    assert t["image_gather"].nbytes == (2 * 3 * 4 * 2 + 2 * 3 * 16 + 2 * 4
                                        + 2 * 3 * 8 * 2 + 2 * 3 * 16)


def test_vqa2_step_least_time_is_bounded_by_adam():
    m = dict(vocab_size=13000, emb_dim=300, feat_dim=2052, hid_dim=1024,
             out_dim=3001, combined_dim=512, n_kernels=8,
             neighbourhood_size=16, n_obj=36)
    assert ops.n_params(m) == 28_203_317      # chip_smoke.py's count
    t = ops.train_ops(m, 64, 64 * 6)
    adam = next(o for o in t if o.name == "adam")
    assert adam.seconds() == pytest.approx(28 * 28_203_317 / 3.35e12)
    assert ops.least_seconds(t) > adam.seconds()


def test_kernel_bounds_by_hand():
    nbytes, ops_s = kernels.edge_bound(b=1, k=2, nd=4, n=2, el=2)
    # sel 4*4 + pseudo 8*4 + gparams 8*4 + proj in and out 2*8*2
    assert nbytes == 16 + 32 + 32 + 32
    assert ops_s == pytest.approx(2 * 4 * 4 / 989e12 + 25 * 8 / 67e12)
    nb, os_ = kernels.gru_bound(t=3, b=2, h=4, steps=5, el=4)
    assert nb == 3 * 2 * 12 * 4 + 48 * 4 + 12 * 4 + 8 + 32
    assert os_ == pytest.approx(2 * 5 * 4 * 12 / 67e12 + 20 * 5 * 4 / 67e12)
    rb, _ = kernels.residual_bound(1, 2, 4, 2, 2, dropout=True)
    assert rb == 112 + 3 * 4 * 4 + 4
    assert kernels.image_bytes(2, 3, 4, 8, 2, 2) == (48 + 96 + 8 + 96 + 96)
    # D: 3 slabs of proj (no epilogue) 3*8*2, K x K slabs 4*4*(1+2+1+2+1+2),
    # gparams in and out 2*4*2*4; two products and 40 ops an edge-kernel
    vb, vs = kernels.vjp_bound(1, 2, 4, 2, 2, epilogue=False)
    assert vb == 48 + 16 * 9 + 64
    assert vs == pytest.approx(2 * 2 * 4 * 4 / 989e12 + 40 * 8 / 67e12)
    # E's sweep: t=2, b=1, h=4; 3 active (row, step), 1 active a step later
    sb, ss = kernels.sweep_bound(2, 1, 4, 3, 1, el=2)
    assert sb == 2 * 12 * 4 * 2 + 48 * 2 + 2 * 4 * 4 + 16 + 48 + 4 + 2 * 12 * 2
    assert ss == pytest.approx(2 * 4 * 12 * 4 / 989e12 + 30 * 4 * 3 / 67e12)
    wb, ws = kernels.wgrad_bound(2, 1, 4, 1, el=2)
    assert wb == 2 * 12 * 2 + 2 * 4 * 2 + 48 * 4 + 48
    assert ws == pytest.approx(2 * 12 * 4 / 989e12)
    assert kernels.least_ms(3.35e9, 0.0) == pytest.approx(1.0)
    assert math.isfinite(kernels.block_bound(1, 3, 8, 4, 2, 2, 2)[1])
