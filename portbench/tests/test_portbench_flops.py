"""The model-flop formula against the figures PERF.md works by hand."""

from portbench import manifest as mf, work

GRANITE = mf.config("granite-34b")["model"]
FALCON = mf.config("falcon-mamba-7b")["model"]


def test_granite_per_token():
    mm = work.matmul_params(GRANITE)
    # wq 6144*6144, wk and wv 6144*128 each, wo 6144*6144, wi and wo 6144*24576
    assert mm["layer"] == 379_060_224
    assert mm["layers"] == 3_032_481_792
    assert mm["head"] == 301_989_888
    # 6 (3,032,481,792 + 301,989,888) + 12 * 48 * 128 * 4,096.5 * 8 a token
    per_token = work.train_step_flops(GRANITE, 1, 8192) / 8192
    assert per_token == 6 * 3_334_471_680 + 12 * 48 * 128 * 8 * 8193 / 2
    assert round(per_token) == 22_423_044_096


def test_falcon_per_token_counts_no_a_d_or_conv():
    mm = work.matmul_params(FALCON)
    # in_x and in_gate 2*4096*8192, x_proj 8192*288, dt_proj 256*8192,
    # out_proj 8192*4096
    assert mm["layer"] == 105_119_744
    assert mm["head"] == 266_338_304
    per_token = work.train_step_flops(FALCON, 2, 4096) / (2 * 4096)
    assert per_token == 6 * (32 * 105_119_744 + 266_338_304) == 21_781_020_672


def test_falcon_leaves_out_what_the_ports_param_count_holds():
    from portbench import program

    cfg = program.arch_config(mf.config("falcon-mamba-7b"))
    total, _ = cfg.param_counts()
    ours = work.matmul_params(FALCON)
    Di, N, Wc = FALCON["d_inner"], FALCON["ssm_state"], FALCON["conv_width"]
    embed = FALCON["vocab"] * FALCON["d_model"]
    a_d_conv = Di * N + Di + Wc * Di  # A, D and the conv: element-wise
    assert total - embed - ours["head"] == FALCON["layers"] * (ours["layer"] + a_d_conv)


def test_serving_flops():
    p = work.prefill_flops(GRANITE, 2048)
    assert p == (2 * 3_032_481_792 * 2048 + 2 * 301_989_888
                 + 4 * 48 * 128 * 8 * 2048 * 2049 // 2)
    d = work.decode_flops(GRANITE, 2047)
    assert d == 2 * 3_334_471_680 + 4 * 48 * 128 * 8 * 2048
