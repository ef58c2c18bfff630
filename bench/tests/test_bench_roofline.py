"""The yardstick's arithmetic, counted by hand and, for the model FLOPs,
by `FlopCounterMode` over the plain references at smoke size."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench import roofline
from bench.lib import weights
from bench.reference import inl_starcoder2, paper_inl
from bench.tests import _smoke

PAPER = _smoke.cell("paper-inl.inl-b64").config["program"]
LLM = _smoke.cell("inl-starcoder2-3b.train-4k").config["program"]


def test_cut_bytes_are_perf_md_closed_forms():
    for R, d in ((320, 64), (20480, 64), (7, 3)):
        assert roofline.cut_fwd_bytes(R, d, 4) == 16 * R * d + 4 * R
        assert roofline.cut_bwd_bytes(R, d, 4) == 28 * R * d + 4 * R
        assert roofline.cut_bwd_bytes(R, d, 4, "none") == 28 * R * d
    # bf16 mu, logvar, u, gu, dmu, dlv; fp32 eps, deps and the rate
    R, d = 16384, 768
    assert roofline.cut_fwd_bytes(R, d, 2) == R * d * (2 + 2 + 4 + 2) + 4 * R
    assert roofline.cut_bwd_bytes(R, d, 2) == \
        R * d * (2 + 2 + 4 + 2 + 2 + 2 + 4) + 4 * R


def test_flash_by_hand():
    # B=1, S=4, H=2, Dh=8: 10 causal pairs a head, 4 Dh FLOPs a pair
    assert roofline.flash_fwd_flops(1, 4, 2, 8) == 4 * 8 * 2 * 10
    assert roofline.flash_fwd_flops(1, 4, 2, 8, causal=False) == 4 * 8 * 2 * 16
    # q, o: 1*4*2*8 bf16 each; k, v: 1*4*1*8; lse 1*4*2 fp32
    assert roofline.flash_fwd_bytes(1, 4, 2, 1, 8) == \
        2 * (2 * 64 + 2 * 32) + 4 * 8
    # StarCoder2 at S=4096: compute-bound, 103 GFLOP a launch
    f = roofline.flash_fwd_flops(1, 4096, 24, 128)
    b = roofline.flash_fwd_bytes(1, 4096, 24, 2, 128)
    peak = roofline.PEAKS["h100"]["bf16_flops_per_s"]
    assert f == 4 * 128 * 24 * 4096 * 4097 // 2
    assert roofline.bound_s(f, b, peak) == f / peak


def test_paper_round_flops_by_hand():
    full = dict(PAPER, conv_channels=[32, 64, 128], d_bottleneck=64,
                dense_units=[512, 256])
    conv = [2 * 9 * 3 * 32 * 1024, 2 * 9 * 32 * 64 * 256,
            2 * 9 * 64 * 128 * 64]
    head = 2 * 2048 * 64
    fwd = sum(conv) + 2 * head
    bwd = conv[0] + 2 * conv[1] + 2 * conv[2] + 4 * head
    dense = 2 * (320 * 512 + 512 * 256 + 256 * 10)
    heads = 2 * 64 * 10 * 5
    inl = 64 * (5 * (fwd + bwd) + 3 * dense + 3 * heads)
    assert roofline.paper_round_flops(full, "inl", 64) == inl
    assert 19e9 < inl < 22e9
    bwd_fl = conv[0] + 2 * conv[1] + 2 * conv[2] + 2 * head
    fl = 10 * 64 * (5 * (fwd + bwd_fl) + 3 * dense)
    assert roofline.paper_round_flops(full, "fl", 64, local_steps=2) == fl


def _counted(fn):
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("scheme", ["inl", "fl"])
def test_paper_round_flops_counted(scheme):
    torch.manual_seed(0)
    cfg, B = PAPER, 8
    w = paper_inl.make_weights(cfg, scheme, 5, "cpu")
    J = cfg["num_clients"]
    gen = torch.Generator().manual_seed(1)
    if scheme == "inl":
        views = torch.randn(1, J, B, 32, 32, 3)
        labels = torch.randint(0, 10, (1, B))
        rounds = [(views[0], labels[0])]

        def run():
            paper_inl.run_inl(cfg, w, rounds, gen, lr=1e-3)
    else:
        views = torch.randn(2 * J, J, B, 32, 32, 3)
        labels = torch.randint(0, 10, (2 * J, B))

        def run():
            paper_inl.run_fl(cfg, w, [(views, labels)], gen, lr=1e-3,
                             local_steps=2)
    assert _counted(run) == roofline.paper_round_flops(cfg, scheme, B)


def test_llm_step_flops_counted():
    m, B, S = LLM, 2, 16
    J, d_b = m["inl"]["num_nodes"], m["inl"]["d_bottleneck"]
    w = inl_starcoder2.make_weights(m, 3, "cpu", torch.float32)
    leaves = {k: v.requires_grad_(True) for k, v in w.items()}
    tokens = torch.randint(0, m["vocab_size"], (B, S))
    noise = torch.randn(J, B, S, m["d_model"])
    eps = torch.randn(J, B, S, d_b)

    def run():
        loss = inl_starcoder2.loss(m, leaves, tokens, tokens, noise, eps,
                                   remat=False)
        torch.autograd.grad(loss, list(leaves.values()))
    assert _counted(run) == roofline.inl_llm_step_flops(m, B, S,
                                                        causal=False)


def test_llm_step_flops_full_size():
    m = dict(LLM, d_model=3072, num_heads=24, head_dim=128, d_ff=12288,
             vocab_size=49152, vocab_size_padded=49152,
             inl=dict(LLM["inl"], d_bottleneck=768))
    per_layer = 2 * (3072 * 3072 * 2 + 2 * 3072 * 256 + 2 * 3072 * 12288)
    per_token = (9 * per_layer + 4 * 4 * 3072 * 768 + 2 * 3072 * 3072
                 + 2 * 3072 * 49152 + 4 * 2 * 768 * 49152)
    attn = 9 * 12 * 128 * 24 * (4096 * 4097 // 2)
    assert roofline.inl_llm_step_flops(m, 1, 4096) == \
        3 * per_token * 4096 + attn
    assert 31e12 < roofline.inl_llm_step_flops(m, 1, 4096) < 33e12


def test_weights_are_the_seeds():
    a = weights.draw("x.w", (3, 4), ("normal", 1.0), seed=2 ** 33 + 5,
                     device="cpu")
    b = weights.draw("x.w", (3, 4), ("normal", 1.0), seed=2 ** 33 + 5,
                     device="cpu")
    c = weights.draw("y.w", (3, 4), ("normal", 1.0), seed=2 ** 33 + 5,
                     device="cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
