"""The port's conv model (repro_torch/core/paper_model) against the JAX
reference, at SMOKE and at the paper's full width, batch 2, rtol/atol 1e-5
(fp32 convolutions and matrix products summed in another order).

Weights are the reference's, converted, with non-trivial BatchNorm
statistics and biases (tests/_torch_common.py): a CHW flatten before the
head, or a conv kernel transposed the wrong way, fails here.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.paper_inl import SMOKE, PaperExperimentConfig  # noqa: E402
from repro.core import paper_model as jpm  # noqa: E402
from repro_torch import tree_map  # noqa: E402
from repro_torch.core import paper_model as tpm  # noqa: E402
from tests._torch_common import jax_inl, torch_inl, views_np  # noqa: E402

CFGS = {"smoke": SMOKE, "full": PaperExperimentConfig()}
TOL = dict(rtol=1e-5, atol=1e-5)


# jitted: one compile per shape instead of an eager compile per op
_jax_encoder = jax.jit(lambda p, s, x: jpm.encoder_apply(p, s, x,
                                                         train=False))


def _node(cfg, j):
    """Node j's encoder params/state in both frameworks."""
    jp, js = jax_inl(cfg)
    tp, ts = torch_inl(cfg)
    pick = (lambda x: x[j])
    return (jax.tree.map(pick, jp.encoders),
            jax.tree.map(pick, js["encoders"]),
            tree_map(pick, tp.encoders), tree_map(pick, ts["encoders"]))


@pytest.mark.parametrize("name", ["smoke", "full"])
def test_encoder_apply_eval_matches_jax(name):
    cfg = CFGS[name]
    x = views_np(cfg, 2)
    for j in (0, cfg.num_clients - 1):
        jp, js, tp, ts = _node(cfg, j)
        (jmu, jlv), _ = _jax_encoder(jp, js, jnp.asarray(x[j]))
        (tmu, tlv), tst = tpm.encoder_apply(tp, ts, torch.from_numpy(x[j]),
                                            train=False)
        np.testing.assert_allclose(tmu.numpy(), np.asarray(jmu), **TOL)
        np.testing.assert_allclose(tlv.numpy(), np.asarray(jlv), **TOL)
        assert tst is not None and len(tst["bns"]) == len(cfg.conv_channels)


def test_encoder_apply_train_batchnorm_matches_jax():
    """The train branch: batch statistics (two-pass biased variance) and
    the running update that weighs the OLD statistic by 0.9."""
    cfg = SMOKE
    x = views_np(cfg, 4)
    jp, js, tp, ts = _node(cfg, 1)
    (jmu, _), jst = jpm.encoder_apply(jp, js, jnp.asarray(x[1]), train=True)
    (tmu, _), tst = tpm.encoder_apply(tp, ts, torch.from_numpy(x[1]),
                                      train=True)
    np.testing.assert_allclose(tmu.numpy(), np.asarray(jmu), **TOL)
    for jb, tb in zip(jst["bns"], tst["bns"]):
        for k in ("mean", "var"):
            np.testing.assert_allclose(tb[k].numpy(), np.asarray(jb[k]),
                                       **TOL)


def test_flatten_order_is_nhwc():
    """The head reads the NHWC flatten: a head weight that is non-zero on
    exactly one NHWC feature picks that feature out."""
    cfg = SMOKE
    _, _, tp, ts = _node(cfg, 0)
    x = torch.from_numpy(views_np(cfg, 2)[0])
    h = x.permute(0, 3, 1, 2)
    for cp, bp, bs in zip(tp["convs"], tp["bns"], ts["bns"]):
        h = tpm.maxpool2(torch.relu(tpm.bn_apply(bp, bs, tpm.conv(cp, h),
                                                 train=False)[0]))
    nhwc = h.permute(0, 2, 3, 1)                       # (B, h, w, C)
    head = {k: {"w": torch.zeros_like(v["w"]), "b": torch.zeros_like(v["b"])}
            for k, v in tp["head"].items()}
    c, y, xx = 3, 1, 0
    flat = (y * nhwc.shape[2] + xx) * nhwc.shape[3] + c
    head["mu"]["w"][flat, 0] = 1.0
    (mu, _), _ = tpm.encoder_apply(dict(tp, head=head), ts, x, train=False)
    np.testing.assert_allclose(mu[:, 0].numpy(), nhwc[:, y, xx, c].numpy(),
                               rtol=0, atol=0)


@pytest.mark.parametrize("name", ["smoke", "full"])
def test_decoder_and_branch_heads_match_jax(name):
    cfg = CFGS[name]
    jp, _ = jax_inl(cfg)
    tp, _ = torch_inl(cfg)
    rng = np.random.default_rng(1)
    u = rng.normal(size=(cfg.num_clients, 2, cfg.d_bottleneck)) \
        .astype(np.float32)
    u_cat = np.moveaxis(u, 0, 1).reshape(2, -1)
    jl = jpm.decoder_apply(jp.decoder, jnp.asarray(u_cat), train=False)
    tl = tpm.decoder_apply(tp.decoder, torch.from_numpy(u_cat), train=False)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    jb = jpm.branch_heads_apply(jp.decoder, jnp.asarray(u))
    tb = tpm.branch_heads_apply(tp.decoder, torch.from_numpy(u))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), **TOL)


def test_decoder_drop_masks_match_jax():
    cfg = SMOKE
    jp, _ = jax_inl(cfg)
    tp, _ = torch_inl(cfg)
    rng = np.random.default_rng(2)
    u_cat = rng.normal(size=(3, cfg.num_clients * cfg.d_bottleneck)) \
        .astype(np.float32)
    masks = [rng.random((3, n)) < 0.7 for n in cfg.dense_units]
    jl = jpm.decoder_apply(jp.decoder, jnp.asarray(u_cat), train=True,
                           drop_masks=[jnp.asarray(m) for m in masks])
    tl = tpm.decoder_apply(tp.decoder, torch.from_numpy(u_cat), train=True,
                           drop_masks=[torch.from_numpy(m) for m in masks])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_compute_dtype_and_init_shapes_match_reference():
    assert tpm.compute_dtype(SMOKE) == torch.float32
    assert tpm.compute_dtype(
        PaperExperimentConfig(compute_dtype="bf16")) == torch.bfloat16
    with pytest.raises(ValueError, match="compute_dtype"):
        tpm.compute_dtype(PaperExperimentConfig(compute_dtype="fp8"))
    g = torch.Generator().manual_seed(0)
    tp, ts = tpm.encoder_init(g, SMOKE)
    key = jax.random.PRNGKey(0)
    # shapes only: eval_shape traces without compiling
    jp, js = jax.eval_shape(lambda k: jpm.encoder_init(k, SMOKE), key)
    for tc, jc in zip(tp["convs"], jp["convs"]):          # OIHW vs HWIO
        h, w, i, o = jc["w"].shape
        assert tuple(tc["w"].shape) == (o, i, h, w)
    assert tuple(tp["head"]["mu"]["w"].shape) == jp["head"]["mu"]["w"].shape
    assert tpm.encoder_feat_dim(SMOKE) == jpm.encoder_feat_dim(SMOKE)
    dec = tpm.decoder_init(g, SMOKE)
    jdec = jax.eval_shape(lambda k: jpm.decoder_init(k, SMOKE), key)
    assert [tuple(d["w"].shape) for d in dec["dense"]] == \
        [d["w"].shape for d in jdec["dense"]]
    assert tuple(dec["branch_heads"]["w"].shape) == \
        jdec["branch_heads"]["w"].shape
