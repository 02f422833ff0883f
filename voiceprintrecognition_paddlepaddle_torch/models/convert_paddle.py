"""Reference ``ppvector`` paddle checkpoints (``model.pdparams``) -> the
port's ``state_dict``, with numpy and pickle alone.

``load_pdparams``, ``convert_state`` and the per-backbone ``SPECS`` are
copies of the JAX package's ``tools/convert_paddle_checkpoint.py``
(``:51-590``): every paddle key of ``nn.Sequential(backbone, classifier)``
(``0.<backbone path>`` / ``1.<classifier path>``) maps to the leaf of the
flax tree of the same architecture, with these layouts:

- Conv1D  ``[out, in, k]``      -> ``(k, in, out)``
- Conv2D  ``[out, in, kh, kw]`` -> ``(kh, kw, in, out)``
- Linear  ``[in, out]``         -> ``(in, out)`` (paddle is input-major)
- BatchNorm ``weight/bias``     -> ``scale/bias``; ``_mean/_variance`` ->
  ``mean/var`` (batch_stats)
- ``create_parameter`` tensors (the Cosine head's weight) verbatim.

The 2-D backbones flatten (channels, freq) channel-major in the reference
(``c*F + f``) and freq-major here (``f*C + c``): every weight on that axis
is permuted (``_flatten_perm``).

``pdparams_to_torch_state`` composes ``convert_state`` with
``convert.jax_to_torch_state``: the flax tree never leaves numpy. The
command line is ``python -m
voiceprintrecognition_paddlepaddle_torch.convert_paddle``.
"""

import io
import pickle

import numpy as np

from .convert import jax_to_torch_state

__all__ = ["SPECS", "convert_state", "load_pdparams",
           "pdparams_to_torch_state"]


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------
def _t_conv1d(w, perm_in=None, perm_out=None):
    w = np.transpose(w, (2, 1, 0))  # (k, in, out)
    if perm_in is not None:
        w = np.take(w, perm_in, axis=1)
    if perm_out is not None:
        w = np.take(w, perm_out, axis=2)
    return w


def _t_conv2d(w):
    return np.transpose(w, (2, 3, 1, 0))  # (kh, kw, in, out)


def _t_dense(w, perm_in=None):
    if perm_in is not None:
        w = np.take(w, perm_in, axis=0)
    return w


def _t_conv1d_as_dense(w):
    """paddle DenseLayer uses Conv1D(k=1) ``[out, in, 1]`` where we use
    ``nn.Dense`` ``(in, out)``."""
    return np.transpose(w[:, :, 0], (1, 0))


def _flatten_perm(f, c):
    """Index permutation taking a reference channel-major flat axis
    (``c*F + f``) to our freq-major one (``f*C + c``):
    ``ours[j] = ref[perm[j]]`` with ``perm[f*C + c] = c*F + f``."""
    j = np.arange(f * c)
    return (j % c) * f + (j // c)


def _blocked(perm, blocks, block_len):
    """Repeat a permutation across concatenated stat blocks
    (mean‖std/var, or x‖mean‖std for ASP's global context)."""
    return np.concatenate([perm + i * block_len for i in range(blocks)])


class Mapper:
    """Accumulates (paddle key -> flax leaf) entries."""

    def __init__(self):
        self.entries = []  # (paddle_key, collection, flax_path, transform)

    # -- module-level helpers (paddle prefix -> flax prefix) --------------
    def conv1d(self, p, f, bias=True, perm_in=None, perm_out=None):
        self.entries.append((f"{p}.weight", "params", f"{f}/kernel",
                             lambda w: _t_conv1d(w, perm_in, perm_out),
                             "conv1d_w"))
        if bias:
            tb = ((lambda b: np.take(b, perm_out)) if perm_out is not None
                  else (lambda b: b))
            self.entries.append((f"{p}.bias", "params", f"{f}/bias", tb,
                                 "vec"))

    def conv2d(self, p, f, bias=True):
        self.entries.append((f"{p}.weight", "params", f"{f}/kernel",
                             _t_conv2d, "conv2d_w"))
        if bias:
            self.entries.append((f"{p}.bias", "params", f"{f}/bias",
                                 lambda b: b, "vec"))

    def dense(self, p, f, bias=True, perm_in=None):
        self.entries.append((f"{p}.weight", "params", f"{f}/kernel",
                             lambda w: _t_dense(w, perm_in), "dense_w"))
        if bias:
            self.entries.append((f"{p}.bias", "params", f"{f}/bias",
                                 lambda b: b, "vec"))

    def conv1d_as_dense(self, p, f, bias=True):
        self.entries.append((f"{p}.weight", "params", f"{f}/kernel",
                             _t_conv1d_as_dense, "conv1d_as_dense_w"))
        if bias:
            self.entries.append((f"{p}.bias", "params", f"{f}/bias",
                                 lambda b: b, "vec"))

    def bn(self, p, f, perm=None):
        t = ((lambda v: np.take(v, perm)) if perm is not None
             else (lambda v: v))
        self.entries.append((f"{p}.weight", "params", f"{f}/scale", t, "vec"))
        self.entries.append((f"{p}.bias", "params", f"{f}/bias", t, "vec"))
        self.entries.append((f"{p}._mean", "batch_stats", f"{f}/mean", t,
                             "vec"))
        self.entries.append((f"{p}._variance", "batch_stats", f"{f}/var", t,
                             "vec"))

    def raw(self, p, f):
        self.entries.append((p, "params", f, lambda v: v, "raw"))

    # -- shared composites -------------------------------------------------
    def tdnn_block(self, p, f):
        """reference models/utils.py TDNNBlock: .conv (Conv1d wrapper) +
        .norm (BatchNorm1d wrapper)."""
        self.conv1d(f"{p}.conv.conv", f"{f}/SamePadConv1d_0/Conv_0")
        self.bn(f"{p}.norm.norm", f"{f}/BatchNorm1d_0/BatchNorm_0")

    def pooling_and_head(self, p_pool, f_pool_cls, pooling_type, perm=None,
                         f_idx_base=0):
        """The pooling module's own parameters for the 1-D head pattern
        (TDNN / Res2Net / ResNetSE): pooling -> BN -> Linear -> BN.
        ``perm`` is the flattened-axis permutation (None for TDNN)."""
        cat = None if perm is None else len(perm)
        if pooling_type == "ASP":
            perm3 = None if perm is None else _blocked(perm, 3, cat)
            self.conv1d(f"{p_pool}.tdnn.conv.conv",
                        f"{f_pool_cls}/TDNNBlock_0/SamePadConv1d_0/Conv_0",
                        perm_in=perm3)
            self.bn(f"{p_pool}.tdnn.norm.norm",
                    f"{f_pool_cls}/TDNNBlock_0/BatchNorm1d_0/BatchNorm_0")
            self.conv1d(f"{p_pool}.conv.conv",
                        f"{f_pool_cls}/SamePadConv1d_0/Conv_0", perm_out=perm)
        elif pooling_type == "SAP":
            self.conv1d(f"{p_pool}.linear1", f"{f_pool_cls}/Conv_0",
                        perm_in=perm)
            self.conv1d(f"{p_pool}.linear2", f"{f_pool_cls}/Conv_1",
                        perm_out=perm)
        # TAP / TSP: parameter-free


POOL_CLS = {"ASP": "AttentiveStatisticsPooling_0",
            "SAP": "SelfAttentivePooling_0",
            "TAP": "TemporalAveragePooling_0",
            "TSP": "TemporalStatisticsPooling_0"}
POOL_N_STATS = {"ASP": 2, "TSP": 2, "SAP": 1, "TAP": 1}


# ---------------------------------------------------------------------------
# per-backbone specs — paddle attribute paths from ppvector's models/*.py,
# flax names from the JAX package's models/
# ---------------------------------------------------------------------------
def spec_tdnn(input_size, channels=512, embd_dim=192, pooling_type="ASP"):
    m = Mapper()
    for i in range(1, 6):
        m.conv1d(f"td_layer{i}", f"Conv_{i - 1}")
    for i in range(1, 5):
        m.bn(f"bn{i}", f"BatchNorm1d_{i - 1}/BatchNorm_0")
    pool_cls = POOL_CLS[pooling_type]
    m.pooling_and_head("pooling", pool_cls, pooling_type)
    m.bn("bn5.norm", "BatchNorm1d_4/BatchNorm_0")
    m.dense("linear", "Dense_0")
    m.bn("bn6.norm", "BatchNorm1d_5/BatchNorm_0")
    return m.entries


def spec_ecapa_tdnn(input_size, embd_dim=192, pooling_type="ASP",
                    channels=(512, 512, 512, 512, 1536),
                    kernel_sizes=(5, 3, 3, 3, 1), dilations=(1, 2, 3, 4, 1),
                    attention_channels=128, res2net_scale=8, se_channels=128,
                    global_context=True):
    m = Mapper()
    m.tdnn_block("blocks.0", "TDNNBlock_0")
    for i in range(1, len(channels) - 1):
        p, f = f"blocks.{i}", f"SERes2NetBlock_{i - 1}"
        if channels[i - 1] != channels[i]:
            m.conv1d(f"{p}.shortcut.conv", f"{f}/SamePadConv1d_0/Conv_0")
        m.tdnn_block(f"{p}.tdnn1", f"{f}/TDNNBlock_0")
        for j in range(res2net_scale - 1):
            m.tdnn_block(f"{p}.res2net_block.blocks.{j}",
                         f"{f}/Res2NetBlock_0/TDNNBlock_{j}")
        m.tdnn_block(f"{p}.tdnn2", f"{f}/TDNNBlock_1")
        m.conv1d(f"{p}.se_block.conv1.conv",
                 f"{f}/SEBlock_0/SamePadConv1d_0/Conv_0")
        m.conv1d(f"{p}.se_block.conv2.conv",
                 f"{f}/SEBlock_0/SamePadConv1d_1/Conv_0")
    m.tdnn_block("mfa", "TDNNBlock_1")
    pool_cls = POOL_CLS[pooling_type]
    m.pooling_and_head("asp", pool_cls, pooling_type)
    # asp_bn is the BatchNorm1d *wrapper* for ASP but a bare nn.BatchNorm1D
    # for SAP/TAP/TSP (reference ecapa_tdnn.py:215-243)
    bn_p = "asp_bn.norm" if pooling_type == "ASP" else "asp_bn"
    m.bn(bn_p, "BatchNorm1d_0/BatchNorm_0")
    m.conv1d("fc.conv", "SamePadConv1d_0/Conv_0")
    return m.entries


def spec_res2net(input_size, m_channels=32, layers=(3, 4, 6, 3),
                 base_width=32, scale=2, embd_dim=192, pooling_type="ASP"):
    m = Mapper()
    expansion = 4
    m.conv2d("conv1", "Conv_0")
    m.bn("bn1", "_BN2d_0/BatchNorm_0")
    nums = 1 if scale == 1 else scale - 1
    in_planes = m_channels
    flax_i = 0
    for stage, (mul, stride) in enumerate(zip((1, 2, 4, 8), (1, 2, 2, 2))):
        planes = m_channels * mul
        for b in range(layers[stage]):
            p = f"layer{stage + 1}.{b}"
            f = f"Bottle2neck_{flax_i}"
            flax_i += 1
            m.conv2d(f"{p}.conv1", f"{f}/Conv_0")
            m.bn(f"{p}.bn1", f"{f}/_BN2d_0/BatchNorm_0")
            for j in range(nums):
                m.conv2d(f"{p}.convs.{j}", f"{f}/Conv_{1 + j}")
                m.bn(f"{p}.bns.{j}", f"{f}/_BN2d_{1 + j}/BatchNorm_0")
            m.conv2d(f"{p}.conv3", f"{f}/Conv_{1 + nums}")
            m.bn(f"{p}.bn3", f"{f}/_BN2d_{1 + nums}/BatchNorm_0")
            if b == 0 and (stride != 1 or in_planes != planes * expansion):
                # the reference downsample is Conv2D + BatchNorm2D
                m.conv2d(f"{p}.downsample.0", f"{f}/Conv_{2 + nums}")
                m.bn(f"{p}.downsample.1", f"{f}/_BN2d_{2 + nums}/BatchNorm_0")
            if b == 0:
                in_planes = planes * expansion
    c = m_channels * 8 * expansion
    f_dim = _conv_chain_res2net(input_size)
    perm = _flatten_perm(f_dim, c)
    pool_cls = POOL_CLS[pooling_type]
    m.pooling_and_head("pooling", pool_cls, pooling_type, perm=perm)
    n_stats = POOL_N_STATS[pooling_type]
    perm_n = _blocked(perm, n_stats, f_dim * c)
    m.bn("bn2.norm", "BatchNorm1d_0/BatchNorm_0", perm=perm_n)
    m.dense("linear", "Dense_0", perm_in=perm_n)
    m.bn("bn3.norm", "BatchNorm1d_1/BatchNorm_0")
    return m.entries


def _conv_chain_res2net(f):
    """Frequency extent after Res2Net's stem+stages (7x7 s3 p1 conv,
    3x3 s2 p1 maxpool, three stride-2 stages)."""
    f = (f + 2 - 7) // 3 + 1
    f = (f + 2 - 3) // 2 + 1
    for _ in range(3):
        f = (f + 2 - 3) // 2 + 1
    return f


def spec_resnet_se(input_size, layers=(3, 4, 6, 3),
                   num_filters=(32, 64, 128, 256), embd_dim=192,
                   pooling_type="ASP"):
    m = Mapper()
    expansion = 2
    m.conv2d("conv1", "Conv_0")
    m.bn("bn1", "_BN2d_0/BatchNorm_0")
    in_planes = num_filters[0]
    flax_i = 0
    for stage, stride in enumerate((1, 2, 2, 2)):
        planes = num_filters[stage]
        for b in range(layers[stage]):
            p = f"layer{stage + 1}.{b}"
            f = f"SEBottleneck_{flax_i}"
            flax_i += 1
            m.conv2d(f"{p}.conv1", f"{f}/Conv_0")
            m.bn(f"{p}.bn1", f"{f}/_BN2d_0/BatchNorm_0")
            m.conv2d(f"{p}.conv2", f"{f}/Conv_1")
            m.bn(f"{p}.bn2", f"{f}/_BN2d_1/BatchNorm_0")
            m.conv2d(f"{p}.conv3", f"{f}/Conv_2")
            m.bn(f"{p}.bn3", f"{f}/_BN2d_2/BatchNorm_0")
            m.dense(f"{p}.se.fc.0", f"{f}/SELayer_0/Dense_0")
            m.dense(f"{p}.se.fc.2", f"{f}/SELayer_0/Dense_1")
            if b == 0 and (stride != 1 or in_planes != planes * expansion):
                m.conv2d(f"{p}.downsample.0", f"{f}/Conv_3")
                m.bn(f"{p}.downsample.1", f"{f}/_BN2d_3/BatchNorm_0")
            if b == 0:
                in_planes = planes * expansion
    c = num_filters[3] * expansion
    f_dim = input_size // 8
    perm = _flatten_perm(f_dim, c)
    pool_cls = POOL_CLS[pooling_type]
    m.pooling_and_head("pooling", pool_cls, pooling_type, perm=perm)
    n_stats = POOL_N_STATS[pooling_type]
    perm_n = _blocked(perm, n_stats, f_dim * c)
    m.bn("bn2.norm", "BatchNorm1d_0/BatchNorm_0", perm=perm_n)
    m.dense("linear", "Dense_0", perm_in=perm_n)
    m.bn("bn3.norm", "BatchNorm1d_1/BatchNorm_0")
    return m.entries


def _spec_eres2net_block(m, p, f, scale, use_aff, has_shortcut):
    m.conv2d(f"{p}.conv1", f"{f}/Conv_0")
    m.bn(f"{p}.bn1", f"{f}/_BN2d_0/BatchNorm_0")
    for i in range(scale):
        if use_aff and i > 0:
            aff_p, aff_f = f"{p}.fuse_models.{i - 1}", f"{f}/AFF_{i - 1}"
            m.conv2d(f"{aff_p}.local_att.0", f"{aff_f}/Conv_0")
            m.bn(f"{aff_p}.local_att.1", f"{aff_f}/_BN2d_0/BatchNorm_0")
            m.conv2d(f"{aff_p}.local_att.3", f"{aff_f}/Conv_1")
            m.bn(f"{aff_p}.local_att.4", f"{aff_f}/_BN2d_1/BatchNorm_0")
        m.conv2d(f"{p}.convs.{i}", f"{f}/Conv_{1 + i}")
        m.bn(f"{p}.bns.{i}", f"{f}/_BN2d_{1 + i}/BatchNorm_0")
    m.conv2d(f"{p}.conv3", f"{f}/Conv_{1 + scale}")
    m.bn(f"{p}.bn3", f"{f}/_BN2d_{1 + scale}/BatchNorm_0")
    if has_shortcut:
        m.conv2d(f"{p}.shortcut.0", f"{f}/Conv_{2 + scale}")
        m.bn(f"{p}.shortcut.1", f"{f}/_BN2d_{2 + scale}/BatchNorm_0")


def _spec_eres2net_stages(m, num_blocks, m_channels, expansion, scale,
                          fuse_from_stage):
    """Shared stage walker; returns the running flax block index after each
    stage so the caller can interleave the downsample/AFF modules."""
    in_planes = m_channels
    flax_i = 0
    stage_end = []
    for stage, (mul, stride) in enumerate(zip((1, 2, 4, 8), (1, 2, 2, 2))):
        planes = m_channels * mul
        use_aff = stage >= fuse_from_stage
        for b in range(num_blocks[stage]):
            s = stride if b == 0 else 1
            has_sc = s != 1 or in_planes != planes * expansion
            _spec_eres2net_block(m, f"layer{stage + 1}.{b}",
                                 f"_BasicBlock_{flax_i}", scale, use_aff,
                                 has_sc)
            flax_i += 1
            in_planes = planes * expansion
        stage_end.append(flax_i)
    return stage_end


def spec_eres2net(input_size, num_blocks=(3, 4, 6, 3), m_channels=32,
                  mul_channel=1, expansion=2, base_width=32, scale=2,
                  embd_dim=192, pooling_type="TSTP", two_emb_layer=False):
    m = Mapper()
    m.conv2d("conv1", "Conv_0")
    m.bn("bn1", "_BN2d_0/BatchNorm_0")
    _spec_eres2net_stages(m, num_blocks, m_channels, expansion, scale,
                          fuse_from_stage=2)

    def aff(p, f):
        m.conv2d(f"{p}.local_att.0", f"{f}/Conv_0")
        m.bn(f"{p}.local_att.1", f"{f}/_BN2d_0/BatchNorm_0")
        m.conv2d(f"{p}.local_att.3", f"{f}/Conv_1")
        m.bn(f"{p}.local_att.4", f"{f}/_BN2d_1/BatchNorm_0")

    m.conv2d("layer1_downsample", "Conv_1")
    aff("fuse_mode12", "AFF_0")
    m.conv2d("layer2_downsample", "Conv_2")
    aff("fuse_mode123", "AFF_1")
    m.conv2d("layer3_downsample", "Conv_3")
    aff("fuse_mode1234", "AFF_2")

    c = m_channels * 16 * mul_channel
    f_dim = input_size // 8
    perm2 = _blocked(_flatten_perm(f_dim, c), 2, f_dim * c)
    m.dense("seg_1", "Dense_0", perm_in=perm2)
    if two_emb_layer:
        m.bn("seg_bn_1", "BatchNorm_0")
        m.dense("seg_2", "Dense_1")
    return m.entries


def spec_eres2netv2(input_size, num_blocks=(3, 4, 6, 3), m_channels=32,
                    expansion=2, base_width=26, scale=2, embd_dim=192,
                    pooling_type="TSTP", two_emb_layer=False):
    m = Mapper()
    m.conv2d("conv1", "Conv_0")
    m.bn("bn1", "_BN2d_0/BatchNorm_0")
    _spec_eres2net_stages(m, num_blocks, m_channels, expansion, scale,
                          fuse_from_stage=2)
    m.conv2d("layer3_ds", "Conv_1")
    m.conv2d("fuse34.local_att.0", "AFF_0/Conv_0")
    m.bn("fuse34.local_att.1", "AFF_0/_BN2d_0/BatchNorm_0")
    m.conv2d("fuse34.local_att.3", "AFF_0/Conv_1")
    m.bn("fuse34.local_att.4", "AFF_0/_BN2d_1/BatchNorm_0")

    c = m_channels * 16
    f_dim = input_size // 8
    perm2 = _blocked(_flatten_perm(f_dim, c), 2, f_dim * c)
    m.dense("seg_1", "Dense_0", perm_in=perm2)
    if two_emb_layer:
        m.bn("seg_bn_1", "BatchNorm_0")
        m.dense("seg_2", "Dense_1")
    return m.entries


def spec_campplus(input_size, embd_dim=512, growth_rate=32, bn_size=4,
                  init_channels=128, config_str="batchnorm-relu",
                  memory_efficient=True):
    import math
    assert config_str == "batchnorm-relu", \
        "converter supports the shipped batchnorm-relu configuration"
    m = Mapper()
    # FCM head (reference campplus.py:246-281): conv1/bn1, two 2-block
    # stages [stride2, stride1], conv2/bn2. Shortcut only in stride-2 blocks.
    m.conv2d("head.conv1", "FCM_0/Conv_0")
    m.bn("head.bn1", "FCM_0/BatchNorm_0")
    flax_i = 0
    for stage in (1, 2):
        for b, stride in enumerate((2, 1)):
            p = f"head.layer{stage}.{b}"
            f = f"FCM_0/BasicResBlock_{flax_i}"
            flax_i += 1
            m.conv2d(f"{p}.conv1", f"{f}/Conv_0")
            m.bn(f"{p}.bn1", f"{f}/BatchNorm_0")
            m.conv2d(f"{p}.conv2", f"{f}/Conv_1")
            m.bn(f"{p}.bn2", f"{f}/BatchNorm_1")
            if stride != 1:
                m.conv2d(f"{p}.shortcut.0", f"{f}/Conv_2")
                m.bn(f"{p}.shortcut.1", f"{f}/BatchNorm_2")
    m.conv2d("head.conv2", "FCM_0/Conv_1")
    m.bn("head.bn2", "FCM_0/BatchNorm_1")

    # x-vector trunk. The stem conv consumes the flattened (C, F/8) axis —
    # permuted to our (F/8, C) order.
    c, f_dim = 32, math.ceil(input_size / 8)
    perm = _flatten_perm(f_dim, c)
    m.conv1d("xvector.tdnn.linear", "TDNNLayer_0/Conv_0", perm_in=perm)
    m.bn("xvector.tdnn.nonlinear.batchnorm",
         "TDNNLayer_0/_NonLinear_0/BatchNorm_0")

    for bi, num_layers in enumerate((12, 24, 16)):
        for li in range(num_layers):
            p = f"xvector.block{bi + 1}.tdnnd{li + 1}"
            f = f"CAMDenseTDNNBlock_{bi}/CAMDenseTDNNLayer_{li}"
            m.bn(f"{p}.nonlinear1.batchnorm", f"{f}/_NonLinear_0/BatchNorm_0")
            m.conv1d(f"{p}.linear1", f"{f}/Conv_0")
            m.bn(f"{p}.nonlinear2.batchnorm", f"{f}/_NonLinear_1/BatchNorm_0")
            m.conv1d(f"{p}.cam_layer.linear_local", f"{f}/CAMLayer_0/Conv_0")
            m.conv1d(f"{p}.cam_layer.linear1", f"{f}/CAMLayer_0/Conv_1")
            m.conv1d(f"{p}.cam_layer.linear2", f"{f}/CAMLayer_0/Conv_2")
        m.bn(f"xvector.transit{bi + 1}.nonlinear.batchnorm",
             f"_NonLinear_{bi}/BatchNorm_0")
        m.conv1d(f"xvector.transit{bi + 1}.linear", f"Conv_{bi}")
    m.bn("xvector.out_nonlinear.batchnorm", "_NonLinear_3/BatchNorm_0")
    m.conv1d_as_dense("xvector.dense.linear", "DenseBN_0/Dense_0")
    m.bn("xvector.dense.nonlinear.batchnorm", "DenseBN_0/BatchNorm_0")
    return m.entries


def spec_classifier(input_dim, num_speakers, classifier_type="Cosine", K=1,
                    num_blocks=0, inter_dim=512):
    m = Mapper()
    for i in range(num_blocks):
        m.conv1d_as_dense(f"blocks.{i}.linear", f"DenseBN_{i}/Dense_0")
        m.bn(f"blocks.{i}.nonlinear.batchnorm", f"DenseBN_{i}/BatchNorm_0")
    if classifier_type == "Cosine":
        m.raw("weight", "weight")
    else:
        m.dense("output", "Dense_0")
    return m.entries


SPECS = {
    "TDNN": spec_tdnn,
    "EcapaTdnn": spec_ecapa_tdnn,
    "Res2Net": spec_res2net,
    "ResNetSE": spec_resnet_se,
    "ERes2Net": spec_eres2net,
    "ERes2NetV2": spec_eres2netv2,
    "CAMPPlus": spec_campplus,
}


# ---------------------------------------------------------------------------
# the conversion
# ---------------------------------------------------------------------------
def _set_path(tree, path, value):
    node = tree
    parts = path.split("/")
    for k in parts[:-1]:
        node = node.setdefault(k, {})
    node[parts[-1]] = value


def convert_state(paddle_state, model_name, input_size, model_args=None,
                  classifier_conf=None, strict=True):
    """paddle ``state_dict`` (dict of numpy arrays; keys with or without
    the ``0.``/``1.`` Sequential prefixes) -> ``{"params", "batch_stats",
    "loss_params"}`` matching this package's checkpoint layout."""
    model_args = dict(model_args or {})
    # normalise: strip Sequential prefixes into backbone/classifier pools
    backbone, classifier = {}, {}
    for k, v in paddle_state.items():
        v = np.asarray(v)
        if k.startswith("0."):
            backbone[k[2:]] = v
        elif k.startswith("1."):
            classifier[k[2:]] = v
        else:
            backbone[k] = v

    out = {"params": {"backbone": {}}, "batch_stats": {"backbone": {}},
           "loss_params": {}}
    used = set()

    def apply(entries, pool, params_root, stats_root, side):
        for pkey, coll, fpath, tf, _kind in entries:
            if pkey not in pool:
                msg = f"missing paddle key for {side}: {pkey}"
                if strict:
                    raise KeyError(msg)
                print(f"warning: {msg}")
                continue
            used.add((side, pkey))
            root = params_root if coll == "params" else stats_root
            _set_path(root, fpath, np.asarray(tf(pool[pkey]),
                                              dtype=np.float32))

    entries = SPECS[model_name](input_size, **model_args)
    apply(entries, backbone, out["params"]["backbone"],
          out["batch_stats"]["backbone"], "backbone")

    if classifier:
        if classifier_conf is None:
            raise ValueError("checkpoint has classifier keys ('1.*'); pass "
                             "classifier_conf={num_speakers, ...}")
        out["params"]["classifier"] = {}
        out["batch_stats"]["classifier"] = {}
        cls_entries = spec_classifier(**classifier_conf)
        apply(cls_entries, classifier, out["params"]["classifier"],
              out["batch_stats"]["classifier"], "classifier")

    extra = ([k for k in backbone if ("backbone", k) not in used]
             + [k for k in classifier if ("classifier", k) not in used])
    if extra:
        msg = f"unconsumed paddle keys: {extra[:8]}{'...' if len(extra) > 8 else ''}"
        if strict:
            raise KeyError(msg)
        print(f"warning: {msg}")
    return out


# ---------------------------------------------------------------------------
# pdparams reader (paddle itself is not needed)
# ---------------------------------------------------------------------------
class _PaddleUnpickler(pickle.Unpickler):
    """``paddle.save(state_dict, ...)`` stores parameters as numpy arrays
    inside a plain pickle; paddle-specific classes appearing in newer
    formats are mapped to inert stand-ins."""

    def find_class(self, module, name):
        if module.startswith("paddle"):
            # tolerate references to paddle types (e.g. ParamBase wrappers)
            return dict
        return super().find_class(module, name)


def load_pdparams(path):
    with open(path, "rb") as fh:
        data = fh.read()
    state = _PaddleUnpickler(io.BytesIO(data)).load()
    flat = {}
    for k, v in state.items():
        arr = np.asarray(v)
        if arr.dtype == object:
            raise ValueError(f"unsupported tensor encoding for {k}; "
                             "re-save the checkpoint with "
                             "paddle.save({k: np.array(v) ...})")
        flat[k] = arr
    return flat


def pdparams_to_torch_state(paddle_state, model_name, input_size,
                            model_args=None, classifier_conf=None):
    """A paddle ``state_dict`` (numpy) -> ``{"model": backbone state_dict}``
    and, when the checkpoint has ``1.*`` keys and ``classifier_conf`` is
    given, ``"classifier"``: float32 tensors for the port's modules."""
    tree = convert_state(paddle_state, model_name, input_size,
                         model_args=model_args,
                         classifier_conf=classifier_conf)
    out = {"model": jax_to_torch_state(
        {"params": tree["params"]["backbone"],
         "batch_stats": tree["batch_stats"]["backbone"]})}
    if "classifier" in tree["params"]:
        out["classifier"] = jax_to_torch_state(
            {"params": tree["params"]["classifier"],
             "batch_stats": tree["batch_stats"].get("classifier", {})})
    return out
