"""Weight bridge between the JAX package's parameter trees and the port's
torch ``state_dict``s.

A JAX tree is ``{"params": {...}, "batch_stats": {...}}`` of numpy arrays
(what the JAX package's checkpoints pickle).  The torch names follow the
reference (Pointcept) layout, so this map is the reference importer's
``_pt_v1_rules`` and ``_st_v1m1_rules`` (tools/import_reference_checkpoint.py)
read backwards; that importer has no PT-v2 rules, and the PT-v2 map below
follows the reference's ``point_transformer_v2m2_base.py`` names.

Leaf transforms:

==========================  ======================================
torch leaf                  JAX leaf
==========================  ======================================
Linear ``weight`` (out,in)  ``params/<p>/kernel`` (in,out), transposed
Linear ``bias``             ``params/<p>/bias``
BN ``weight``               ``params/<p>/scale``
BN ``bias``                 ``params/<p>/bias``
BN ``running_mean``         ``batch_stats/<p>/mean``
BN ``running_var``          ``batch_stats/<p>/var``
BN ``num_batches_tracked``  (none: 0 on the way in, dropped out)
LayerNorm ``weight``        ``params/<p>/scale``
LayerNorm ``bias``          ``params/<p>/bias``
``relative_pos_*_table``    ``params/<p>/rel_*_table`` (2L, H, hd, 3), as is
KPConv ``weight``           ``params/<p>/kp_weight`` (P, C_in, C_mid), as is
KPConv ``K_points`` buffer  ``batch_stats/<p>/kp_points`` (P, 3)
sparse conv ``weight``      ``params/<p>/kernel`` (K, C_in, C_out), as is
RPE ``rpe_table``           ``params/<p>/rpe_table`` (3 rpe_num, H), as is
cRSE ``<side>_<g>_table``   ``params/<p>/<side>_<g>_table`` (3, 2L, H, hd), as is
depthwise conv ``weight``   ``params/<p>/kernel`` (K, C), as is
==========================  ======================================

Module map (``{s}`` a stage digit, ``{st}`` enc or dec, torch block
``{i}`` >= 1 is JAX ``block{i-1}``):

Segmentor (``DefaultSegmentor``; JAX root ``backbone_module``)
  backbone.enc{s}.0.linear          enc{s}/down/linear       Linear
  backbone.enc{s}.0.bn              enc{s}/down/bn           BN
  backbone.dec{s}.0.linear1.0       dec{s}/up/linear1        Linear
  backbone.dec{s}.0.linear1.1       dec{s}/up/bn1            BN
  backbone.dec{s}.0.linear2.0       dec{s}/up/linear2        Linear
  backbone.dec{s}.0.linear2.1       dec{s}/up/bn2            BN
  backbone.{st}{s}.{i}.linear1      {st}{s}/block{i-1}/linear1             Linear
  backbone.{st}{s}.{i}.bn1          .../bn1                                BN
  backbone.{st}{s}.{i}.transformer.linear_q|k|v   .../transformer/linear_q|k|v
  backbone.{st}{s}.{i}.transformer.linear_p.0     .../transformer/linear_p1
  backbone.{st}{s}.{i}.transformer.linear_p.1     .../transformer/bn_p     BN
  backbone.{st}{s}.{i}.transformer.linear_p.3     .../transformer/linear_p2
  backbone.{st}{s}.{i}.transformer.linear_w.0     .../transformer/bn_w1    BN
  backbone.{st}{s}.{i}.transformer.linear_w.2     .../transformer/linear_w1
  backbone.{st}{s}.{i}.transformer.linear_w.3     .../transformer/bn_w2    BN
  backbone.{st}{s}.{i}.transformer.linear_w.5     .../transformer/linear_w2
  backbone.{st}{s}.{i}.bn2 / linear3 / bn3        .../bn2 / linear3 / bn3
  backbone.cls.0 / cls.1 / cls.3    cls1 / cls_bn / cls2

Recognizer (``PTRecognizer``; JAX root is the recognizer tree)
  dec{s}.linear1.0 / linear1.1      dec{s}/linear1 / bn1
  dec{s}.linear2.0 / linear2.1      dec{s}/linear2 / bn2
  conf.0 / conf.1 / conf.3          conf1 / conf_bn / conf2

Stratified Transformer (``{l}`` a torch layer, JAX ``layer{l+1}``; ``{d}`` a
block; ``num_layers`` is read off the keys)
  backbone.stem_layer.{k}.kpconv              stem{k} (kp_weight, kp_points)
  backbone.stem_layer.0.bn                    stem0/bn                   BN
  backbone.stem_layer.1.unary_1.0 / .1        stem1/unary1 / unary1_bn
  backbone.stem_layer.1.unary_2.0 / .1        stem1/unary2 / unary2_bn
  backbone.stem_layer.1.shortcut_op.0 / .1    stem1/shortcut / shortcut_bn
  backbone.downsample.norm / linear           stem_down/norm / linear
  backbone.layers.{l}.blocks.{d}.norm1|norm2  layer{l+1}_block{d}/norm1|norm2   LayerNorm
  backbone.layers.{l}.blocks.{d}.attn.qkv|proj          .../attn/qkv|proj
  backbone.layers.{l}.blocks.{d}.attn.relative_pos_*_table   .../attn/rel_*_table
  backbone.layers.{l}.blocks.{d}.mlp.fc1|fc2            .../mlp_fc1|mlp_fc2
  backbone.layers.{l}.downsample.norm|linear            down{l+1}/norm|linear
  backbone.upsamples.{u}.linear1.0 / .1       up{w}/norm1 / linear1
  backbone.upsamples.{u}.linear2.0 / .1       up{w}/norm2 / linear2
      (w = num_layers-1-u, and 0 for the last, which lands on the stem)
  backbone.classifier.0 / .1 / .3             cls_fc1 / cls_bn / cls_fc2

ST recognizer (``STRecognizer``)
  upsamples.{d}.linear1.0 / .1, linear2.0 / .1   up{d}/norm1 / linear1, norm2 / linear2
  classifier.0 / .1 / .3                      conf_fc1 / conf_bn / conf_fc2

Point Transformer V2 (``{b}`` a block, the same index on both sides; a
torch BN is the ``.norm`` of a ``PointBatchNorm``)
  backbone.patch_embed.proj.0 / .1.norm       patch_proj / patch_bn
  backbone.patch_embed.blocks.blocks.{b}.     patch_blocks/block{b}/
  backbone.enc_stages.{s}.down.fc / .norm.norm   enc{s}_pool/fc / norm
  backbone.enc_stages.{s}.blocks.blocks.{b}.     enc{s}_blocks/block{b}/
  backbone.dec_stages.{s}.up.proj.0 / .1.norm    dec{s}_unpool/proj_fc / proj_bn
  backbone.dec_stages.{s}.up.proj_skip.0 / .1.norm   dec{s}_unpool/skip_fc / skip_bn
  backbone.dec_stages.{s}.blocks.blocks.{b}.     dec{s}_blocks/block{b}/
  backbone.seg_head.0 / .1.norm / .3          seg_fc1 / seg_bn / seg_fc2
  in a block:
  fc1 / norm1.norm / norm2.norm / fc3 / norm3.norm   fc1 / norm1 / norm2 / fc3 / norm3
  attn.linear_q.0 / attn.q_fc1 / attn.linear_q.1.norm   attn/linear_q / q_fc1 / q_bn
  attn.linear_k.0 / attn.k_fc1 / attn.linear_k.1.norm   attn/linear_k / k_fc1 / k_bn
  attn.linear_v                               attn/linear_v
  attn.linear_p_bias.0 / .1.norm / .3         attn/peb_fc1 / peb_bn / peb_fc2
  attn.linear_p_multiplier.0 / .1.norm / .3   attn/pem_fc1 / pem_bn / pem_fc2
  attn.weight_encoding.0 / .1.norm / .3       attn/we_fc1 / we_bn / we_fc2

PT-v2m3: each BatchNorm is a ``PDMaskedBatchNorm`` in the place of the
``PointBatchNorm`` (the reference's ``PDBatchNorm``); the JAX module stacks
its banks as ``(n_bank, C)`` leaves under the same name
  <X>.bns.{i}.weight / bias / running_mean / running_var   <P>/scale|bias|mean|var, row i
  <X>.bn.*  (not decoupled)                                <P>/..., row 0
  <X>.modulation.1                                         <P>/modulation  Linear
where ``<X>.norm`` is the PT-v2m2 name of that BatchNorm and ``<P>`` its
JAX path.  A JAX tree's banks come out as ``bns.{i}`` (a norm that is not
decoupled loads ``bns.0`` as ``bn``).

SpUNet / MinkUNet (``{st}`` enc or dec, ``{b}`` a block, the same index on
both sides; Pointcept ``spconv_unet_v1m1_base.py`` names)
  backbone.conv_input.0 / .1                  conv_input / bn_input
  backbone.down.{s}.0 / .1                    down{s} / down_bn{s}
  backbone.up.{s}.0 / .1                      up{s} / up_bn{s}
  backbone.{st}.{s}.block{b}.conv1|conv2|conv3   {st}{s}_block{b}/conv1|conv2|conv3
  backbone.{st}.{s}.block{b}.bn1|bn2|bn3         {st}{s}_block{b}/bn1|bn2|bn3
  backbone.{st}.{s}.block{b}.proj.0 / .1      {st}{s}_block{b}/proj / proj_bn
  backbone.final                              final
A sparse conv's weight is 3-D; a 2-D one under the same names (the 1x1
``proj``, the bottleneck's ``conv1`` / ``conv3``, ``final``) is a Linear.
SpUNet-v1m3's PD norms sit in the BatchNorms' own places (``<X>.bns.{i}``
where SpUNet-v1m1 has ``<X>``), under the same JAX paths.

Point Transformer V3 (``PT-v3m1`` under ``DefaultSegmentorV2``; ``{st}``
enc or dec, ``{b}`` a block, the same indices on both sides; Pointcept
``point_transformer_v3m1_base.py`` names)
  backbone.embedding.stem.conv / .norm        embedding / embedding_bn
  backbone.{st}.{st}{s}.block{b}.             {st}{s}_block{b}/
  backbone.enc.enc{s}.down.proj / .norm.0     pool{s}_proj / pool{s}_bn
  backbone.dec.dec{s}.up.proj.0 / .1          unpool{s}_proj / unpool{s}_bn
  backbone.dec.dec{s}.up.proj_skip.0 / .1     unpool{s}_skip / unpool{s}_skip_bn
  seg_head                                    seg_head (the segmentor's)
  in a block:
  cpe.0 / cpe.1 / cpe.2                       cpe_conv (with bias) / cpe_fc / cpe_norm
  norm1.0 / norm2.0                           norm1 / norm2
  attn.qkv / attn.proj / attn.rpe.rpe_table   attn/qkv / attn/proj / attn/rpe/rpe_table
  mlp.0.fc1 / mlp.0.fc2                       mlp_fc1 / mlp_fc2
A plain LayerNorm ``<X>`` is the JAX ``<P>/ln``; with ``pdnorm_ln`` it is a
``PDLayerNorm``, whose banks ``<X>.norm.{i}.weight / bias`` (``<X>.norm``
when not decoupled) are rows of the JAX ``<P>/scale | bias`` (n_bank, C) and
whose ``<X>.modulation.1`` is ``<P>/modulation``.  ``pdnorm_bn``'s banks sit
in the BatchNorms' places, as SpUNet-v1m3's do.  The RPE table (3 rpe_num,
H) goes as is.

Context-aware classifier (``CAC-v1m1``; the backbone under ``backbone.`` /
``backbone_module``, as a segmentor's)
  seg_head.weight / .bias                     proto (as is) / seg_bias
  proj.0 / proj.2                             proj1 / proj2
  apd_proj.0 / apd_proj.2                     apd_proj1 / apd_proj2
  feat_proj_layer.0 / .1 / .3                 feat_fc1 / feat_bn / feat_fc2

Point Prompt Training (``PPT-v1m1`` / ``PPT-v1m2``; the backbone under
``backbone.`` / ``backbone_module``, as a segmentor's, PD banks and all)
  embedding_table.weight                      embedding_table/embedding (as is)
  proj_head                                   proj_head                  Linear
  class_embedding / logit_scale               class_embedding / logit_scale (as is)
  seg_heads.{i}                               seg_head_{i}               Linear

Swin3D (``Swin3D-v1m1`` under ``DefaultSegmentor``; Pointcept
``swin3d_v1m1_base.py`` / ``swin3d_layers.py`` names; ``{l}`` a torch layer,
JAX ``layer{l + s}`` with ``s`` 0, or 1 where the stem downsamples
(``stem_down`` in the tree, ``downsample`` in the state_dict); ``{u}`` an
upsample, JAX ``up{L - 1 - u}`` of ``L`` layers)
  backbone.stem_layer.conv / .norm            stem_conv / stem_bn
  backbone.stem_layer.0.conv / .0.norm        stem_conv / stem_bn   (stem_transformer=False)
  backbone.stem_layer.1.conv1|bn1|conv2|bn2   stem_res/conv1|bn1|conv2|bn2
  backbone.downsample.norm / .linear          stem_down/norm / linear
  backbone.layers.{l}.blocks.{d}.             layer{i}_block{d}/
  backbone.layers.{l}.downsample.norm|linear  down{i}/norm|linear
  backbone.upsamples.{u}.linear1.0 / .1       up{w}/norm1 / linear1
  backbone.upsamples.{u}.linear2.0 / .1       up{w}/norm2 / linear2
  backbone.upsamples.{u}.block.blocks.0.      up{w}_attn/
  backbone.classifier.0 / .1 / .3             cls_fc1 / cls_bn / cls_fc2
  in a block:
  norm1 / norm2 / attn.qkv / attn.proj        norm1 / norm2 / attn/qkv / attn/proj
  attn.<side>_<g>_table                       attn/<side>_<g>_table
  mlp.fc1 / mlp.fc2                           mlp_fc1 / mlp_fc2
The stem follows the reference's ``stem_layer`` and its ``conv`` / ``norm``
as far as they can be known here (the reference's stem modules are not at
hand to check); its residual block keeps the JAX package's (SpUNet's)
``conv1`` / ``bn1`` / ``conv2`` / ``bn2``.

OctFormer (``OctFormer-v1m1`` under ``DefaultSegmentor``; Pointcept
``octformer_v1m1_base.py`` names)
  backbone.patch_embed.convs.{s}.conv / .bn         stem_conv{s}/conv / bn
  backbone.patch_embed.downsamples.{s}.conv / .bn   stem_down{s}_conv / stem_down{s}_bn
  backbone.patch_embed.proj.conv / .bn              stem_proj/conv / bn
  backbone.layers.{s}.blocks.{b}.                   stage{s}_block{b}/
  backbone.downsamples.{s}.conv / .norm             stage_down{s}_conv / stage_down{s}_bn
  backbone.decoder.conv1x1.{s}                      fpn_1x1_{s}
  backbone.decoder.conv3x3.{s}.conv / .bn           fpn_3x3_{s}/conv / bn
  backbone.decoder.up_conv.{s}.deconv / .bn         head_up{s}_conv / head_up{s}_bn
  backbone.seg_head.0 / .1 / .3                     head_fc1 / head_bn / head_fc2
  in a block:
  cpe.conv / cpe.bn                           cpe (kernel (27, C)) / cpe/bn
  norm1 / norm2                               norm1 / norm2
  attention.qkv / .proj / .rpe.rpe_table      attn/qkv / attn/proj / attn/rpe/rpe_table
  mlp.fc1 / mlp.fc2                           mlp_fc1 / mlp_fc2
A convolution's weight there is the JAX kernel as is (ocnn names it
``weights``).

PointGroup (``PG-v1m1``; Pointcept ``point_group_v1m1_base.py`` names; its
backbone under ``backbone.`` / ``backbone_module`` by the rules above)
  bias_head.0 / .1 / .3                       bias_fc1 / bias_bn / bias_fc2
  seg_head                                    seg_head
Over a PPT backbone (``PPT-v1m1`` in ``backbone_mode``) the PPT's own tree
nests: ``backbone.<PPT name>`` / ``backbone_module/<PPT path>``.

OA-CNNs (``OACNNs`` under ``DefaultSegmentor``; Pointcept
``oacnns_v1m1_base.py`` names as far as the JAX structure maps onto them;
``{i}`` a grid size's index, S a block's count of them)
  backbone.stem.{0,3,6} / .{1,4,7}            stem{0,1,2} / stem_bn{0,1,2}
  backbone.enc.{s}.down.0 / .1                down{s} / down_bn{s}
  backbone.enc.{s}.blocks.{b}.                enc{s}_block{b}/
  backbone.dec.{s}.up.0 / .1                  up{s} / up_bn{s}
  backbone.dec.{s}.fuse.0 / .1 / .3 / .4      fuse{s}_fc1 / _bn1 / _fc2 / _bn2
  backbone.final                              final                     Linear
  in a block:
  l_w.{i}.0 / .1                              lw{i}_fc / lw{i}_bn
  weight.{i}                                  weight{i}
  proj.{i}.0 / .1 (i < S)                     proj{i}_fc / proj{i}_bn
  proj.{S}.0 / .1                             proj_last_fc / proj_last_bn
  adaptive / fuse.0 / fuse.1                  adaptive / fuse_fc / fuse_bn
  voxel_block.0 / .1 / .3 / .4                conv1 / bn1 / conv2 / bn2
Every JAX leaf has a name there.  Without a counterpart: decoder blocks of
``dec_depth`` (the JAX module has one fuse a stage and none, so no
``dec.{s}.blocks``), and ``final``'s kernel axes (a Linear here and in
JAX, a 1x1 sparse conv in the reference, whose kernel holds unit axes).

Two differences from the reference are the JAX package's and carry over as
they are.  Its PT-v2 attention applies a second Linear to q and to k ahead of
their BatchNorms (``q_fc1`` / ``k_fc1``, no reference counterpart: a
reference checkpoint leaves them to be filled); its ST LayerNorms run at
Flax's epsilon, 1e-6, where the reference's run at 1e-5.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np
import torch

from .utils.checkpoint import flatten_tree, unflatten_tree

_B = "backbone_module/"
_BLOCK_TAILS = (
    ("linear1", "linear1", "linear"), ("bn1", "bn1", "bn"),
    ("transformer.linear_q", "transformer/linear_q", "linear"),
    ("transformer.linear_k", "transformer/linear_k", "linear"),
    ("transformer.linear_v", "transformer/linear_v", "linear"),
    ("transformer.linear_p.0", "transformer/linear_p1", "linear"),
    ("transformer.linear_p.1", "transformer/bn_p", "bn"),
    ("transformer.linear_p.3", "transformer/linear_p2", "linear"),
    ("transformer.linear_w.0", "transformer/bn_w1", "bn"),
    ("transformer.linear_w.2", "transformer/linear_w1", "linear"),
    ("transformer.linear_w.3", "transformer/bn_w2", "bn"),
    ("transformer.linear_w.5", "transformer/linear_w2", "linear"),
    ("bn2", "bn2", "bn"), ("linear3", "linear3", "linear"),
    ("bn3", "bn3", "bn"),
)

_ST_BLOCK = ("backbone.layers.{j}.blocks.{d}.", _B + "layer{i}_block{d}/")
_ST_RULES = [
    ("backbone.stem_layer.{k}.kpconv", _B + "stem{k}", "kpconv"),
    ("backbone.stem_layer.0.bn", _B + "stem0/bn", "bn"),
    ("backbone.stem_layer.1.unary_1.0", _B + "stem1/unary1", "linear"),
    ("backbone.stem_layer.1.unary_1.1", _B + "stem1/unary1_bn", "bn"),
    ("backbone.stem_layer.1.unary_2.0", _B + "stem1/unary2", "linear"),
    ("backbone.stem_layer.1.unary_2.1", _B + "stem1/unary2_bn", "bn"),
    ("backbone.stem_layer.1.shortcut_op.0", _B + "stem1/shortcut", "linear"),
    ("backbone.stem_layer.1.shortcut_op.1", _B + "stem1/shortcut_bn", "bn"),
    ("backbone.downsample.norm", _B + "stem_down/norm", "ln"),
    ("backbone.downsample.linear", _B + "stem_down/linear", "linear"),
    *[(_ST_BLOCK[0] + tt, _ST_BLOCK[1] + jt, k) for tt, jt, k in (
        ("norm1", "norm1", "ln"), ("norm2", "norm2", "ln"),
        ("attn.qkv", "attn/qkv", "linear"), ("attn.proj", "attn/proj", "linear"),
        ("attn", "attn", "tables"),
        ("mlp.fc1", "mlp_fc1", "linear"), ("mlp.fc2", "mlp_fc2", "linear"))],
    ("backbone.layers.{j}.downsample.norm", _B + "down{i}/norm", "ln"),
    ("backbone.layers.{j}.downsample.linear", _B + "down{i}/linear", "linear"),
    *[(f"{tp}.linear{n}.0", f"{jp}/norm{n}", "ln") for n in (1, 2)
      for tp, jp in (("backbone.upsamples.{u}", _B + "up{w}"),
                     ("upsamples.{d}", "up{d}"))],
    *[(f"{tp}.linear{n}.1", f"{jp}/linear{n}", "linear") for n in (1, 2)
      for tp, jp in (("backbone.upsamples.{u}", _B + "up{w}"),
                     ("upsamples.{d}", "up{d}"))],
    ("backbone.classifier.0", _B + "cls_fc1", "linear"),
    ("backbone.classifier.1", _B + "cls_bn", "bn"),
    ("backbone.classifier.3", _B + "cls_fc2", "linear"),
    ("classifier.0", "conf_fc1", "linear"),
    ("classifier.1", "conf_bn", "bn"),
    ("classifier.3", "conf_fc2", "linear"),
]

# PT-v2: a block's tail under its path, both sides; the attention's three
# MLPs as (reference name, JAX prefix)
_PTV2_BLOCK_TAILS = (
    ("fc1", "fc1", "linear"), ("norm1.norm", "norm1", "pointbn"),
    *[t for n in ("q", "k") for t in (
        (f"attn.linear_{n}.0", f"attn/linear_{n}", "linear"),
        (f"attn.{n}_fc1", f"attn/{n}_fc1", "linear"),
        (f"attn.linear_{n}.1.norm", f"attn/{n}_bn", "pointbn"))],
    ("attn.linear_v", "attn/linear_v", "linear"),
    *[t for ref, jp in (("linear_p_bias", "peb"), ("linear_p_multiplier", "pem"),
                        ("weight_encoding", "we")) for t in (
        (f"attn.{ref}.0", f"attn/{jp}_fc1", "linear"),
        (f"attn.{ref}.1.norm", f"attn/{jp}_bn", "pointbn"),
        (f"attn.{ref}.3", f"attn/{jp}_fc2", "linear"))],
    ("norm2.norm", "norm2", "pointbn"), ("fc3", "fc3", "linear"),
    ("norm3.norm", "norm3", "pointbn"),
)
_PTV2_RULES = [
    ("backbone.patch_embed.proj.0", _B + "patch_proj", "linear"),
    ("backbone.patch_embed.proj.1.norm", _B + "patch_bn", "pointbn"),
    *[(f"backbone.patch_embed.blocks.blocks.{{b}}.{tt}",
       _B + f"patch_blocks/block{{b}}/{jt}", k) for tt, jt, k in _PTV2_BLOCK_TAILS],
    *[(f"backbone.{{st}}_stages.{{s}}.blocks.blocks.{{b}}.{tt}",
       _B + f"{{st}}{{s}}_blocks/block{{b}}/{jt}", k) for tt, jt, k in _PTV2_BLOCK_TAILS],
    ("backbone.enc_stages.{s}.down.fc", _B + "enc{s}_pool/fc", "linear"),
    ("backbone.enc_stages.{s}.down.norm.norm", _B + "enc{s}_pool/norm", "pointbn"),
    ("backbone.dec_stages.{s}.up.proj.0", _B + "dec{s}_unpool/proj_fc", "linear"),
    ("backbone.dec_stages.{s}.up.proj.1.norm", _B + "dec{s}_unpool/proj_bn", "pointbn"),
    ("backbone.dec_stages.{s}.up.proj_skip.0", _B + "dec{s}_unpool/skip_fc", "linear"),
    ("backbone.dec_stages.{s}.up.proj_skip.1.norm", _B + "dec{s}_unpool/skip_bn", "pointbn"),
    ("backbone.seg_head.0", _B + "seg_fc1", "linear"),
    ("backbone.seg_head.1.norm", _B + "seg_bn", "pointbn"),
    ("backbone.seg_head.3", _B + "seg_fc2", "linear"),
]

# SpUNet / MinkUNet ("conv": a 3-D sparse-conv kernel as is, a 2-D Linear
# transposed)
_SPUNET_RULES = [
    ("backbone.conv_input.0", _B + "conv_input", "conv"),
    ("backbone.conv_input.1", _B + "bn_input", "bn"),
    ("backbone.down.{s}.0", _B + "down{s}", "conv"),
    ("backbone.down.{s}.1", _B + "down_bn{s}", "bn"),
    ("backbone.up.{s}.0", _B + "up{s}", "conv"),
    ("backbone.up.{s}.1", _B + "up_bn{s}", "bn"),
    *[(f"backbone.{{st}}.{{s}}.block{{b}}.{tt}", _B + f"{{st}}{{s}}_block{{b}}/{jt}", k)
      for tt, jt, k in (*[(f"{n}{i}", f"{n}{i}", kind) for i in (1, 2, 3)
                          for n, kind in (("conv", "conv"), ("bn", "bn"))],
                        ("proj.0", "proj", "conv"), ("proj.1", "proj_bn", "bn"))],
    ("backbone.final", _B + "final", "conv"),
]

# PT-v3 (each LayerNorm place twice: plain, "ln", and a PDLayerNorm's
# banks, "pdln")
_PTV3_BLOCK_TAILS = (
    ("cpe.0", "cpe_conv", "conv"), ("cpe.1", "cpe_fc", "linear"),
    *[t for tt, jt in (("cpe.2", "cpe_norm"), ("norm1.0", "norm1"), ("norm2.0", "norm2"))
      for t in ((tt, f"{jt}/ln", "ln"), (tt, jt, "pdln"))],
    ("attn.qkv", "attn/qkv", "linear"), ("attn.proj", "attn/proj", "linear"),
    ("attn.rpe", "attn/rpe", "rpe"),
    ("mlp.0.fc1", "mlp_fc1", "linear"), ("mlp.0.fc2", "mlp_fc2", "linear"),
)
_PTV3_RULES = [
    ("backbone.embedding.stem.conv", _B + "embedding", "conv"),
    ("backbone.embedding.stem.norm", _B + "embedding_bn", "bn"),
    *[(f"backbone.{{st}}.{{st}}{{s}}.block{{b}}.{tt}", _B + f"{{st}}{{s}}_block{{b}}/{jt}", k)
      for tt, jt, k in _PTV3_BLOCK_TAILS],
    ("backbone.enc.enc{s}.down.proj", _B + "pool{s}_proj", "linear"),
    ("backbone.enc.enc{s}.down.norm.0", _B + "pool{s}_bn", "bn"),
    ("backbone.dec.dec{s}.up.proj.0", _B + "unpool{s}_proj", "linear"),
    ("backbone.dec.dec{s}.up.proj.1", _B + "unpool{s}_bn", "bn"),
    ("backbone.dec.dec{s}.up.proj_skip.0", _B + "unpool{s}_skip", "linear"),
    ("backbone.dec.dec{s}.up.proj_skip.1", _B + "unpool{s}_skip_bn", "bn"),
    ("seg_head", "seg_head", "linear"),
]

# CAC-v1m1's own modules; its prototypes are root leaves (_ROOT_LEAVES)
_CAC_RULES = [
    ("proj.0", "proj1", "linear"), ("proj.2", "proj2", "linear"),
    ("apd_proj.0", "apd_proj1", "linear"), ("apd_proj.2", "apd_proj2", "linear"),
    ("feat_proj_layer.0", "feat_fc1", "linear"),
    ("feat_proj_layer.1", "feat_bn", "bn"),
    ("feat_proj_layer.3", "feat_fc2", "linear"),
]
_ROOT_LEAVES = {"seg_head.weight": "params/proto",
                "seg_head.bias": "params/seg_bias"}

# PPT's own modules; its class table and logit scale are root leaves
_PPT_RULES = [
    ("embedding_table", "embedding_table", "embed"),
    ("proj_head", "proj_head", "linear"),
    ("seg_heads.{b}", "seg_head_{b}", "linear"),
]
_PPT_ROOT_LEAVES = {"class_embedding": "params/class_embedding",
                    "logit_scale": "params/logit_scale"}

# Swin3D ("sl" a torch layer, "si" its JAX layer: sl + the layer start;
# "su" a torch upsample, "sw" its JAX level: num_layers - 1 - su)
_SWIN3D_BLOCK_TAILS = (
    ("norm1", "norm1", "ln"), ("norm2", "norm2", "ln"),
    ("attn.qkv", "attn/qkv", "linear"), ("attn.proj", "attn/proj", "linear"),
    ("attn", "attn", "crse"),
    ("mlp.fc1", "mlp_fc1", "linear"), ("mlp.fc2", "mlp_fc2", "linear"),
)
_SWIN3D_RULES = [
    ("backbone.stem_layer.conv", _B + "stem_conv", "conv"),
    ("backbone.stem_layer.norm", _B + "stem_bn", "bn"),
    ("backbone.stem_layer.0.conv", _B + "stem_conv", "conv"),
    ("backbone.stem_layer.0.norm", _B + "stem_bn", "bn"),
    *[(f"backbone.stem_layer.1.{n}", _B + f"stem_res/{n}", kind)
      for n, kind in (("conv1", "conv"), ("bn1", "bn"), ("conv2", "conv"), ("bn2", "bn"))],
    ("backbone.downsample.norm", _B + "stem_down/norm", "ln"),
    ("backbone.downsample.linear", _B + "stem_down/linear", "linear"),
    *[(f"backbone.layers.{{sl}}.blocks.{{d}}.{tt}", _B + f"layer{{si}}_block{{d}}/{jt}", k)
      for tt, jt, k in _SWIN3D_BLOCK_TAILS],
    ("backbone.layers.{sl}.downsample.norm", _B + "down{si}/norm", "ln"),
    ("backbone.layers.{sl}.downsample.linear", _B + "down{si}/linear", "linear"),
    ("backbone.upsamples.{su}.linear1.0", _B + "up{sw}/norm1", "ln"),
    ("backbone.upsamples.{su}.linear1.1", _B + "up{sw}/linear1", "linear"),
    ("backbone.upsamples.{su}.linear2.0", _B + "up{sw}/norm2", "ln"),
    ("backbone.upsamples.{su}.linear2.1", _B + "up{sw}/linear2", "linear"),
    *[(f"backbone.upsamples.{{su}}.block.blocks.0.{tt}", _B + f"up{{sw}}_attn/{jt}", k)
      for tt, jt, k in _SWIN3D_BLOCK_TAILS],
    ("backbone.classifier.0", _B + "cls_fc1", "linear"),
    ("backbone.classifier.1", _B + "cls_bn", "bn"),
    ("backbone.classifier.3", _B + "cls_fc2", "linear"),
]

# OctFormer
_OCTFORMER_RULES = [
    ("backbone.patch_embed.convs.{s}.conv", _B + "stem_conv{s}/conv", "conv"),
    ("backbone.patch_embed.convs.{s}.bn", _B + "stem_conv{s}/bn", "bn"),
    ("backbone.patch_embed.downsamples.{s}.conv", _B + "stem_down{s}_conv", "conv"),
    ("backbone.patch_embed.downsamples.{s}.bn", _B + "stem_down{s}_bn", "bn"),
    ("backbone.patch_embed.proj.conv", _B + "stem_proj/conv", "conv"),
    ("backbone.patch_embed.proj.bn", _B + "stem_proj/bn", "bn"),
    *[(f"backbone.layers.{{s}}.blocks.{{b}}.{tt}", _B + f"stage{{s}}_block{{b}}/{jt}", k)
      for tt, jt, k in (("cpe.conv", "cpe", "dwconv"), ("cpe.bn", "cpe/bn", "bn"),
                        ("norm1", "norm1", "ln"), ("norm2", "norm2", "ln"),
                        ("attention.qkv", "attn/qkv", "linear"),
                        ("attention.proj", "attn/proj", "linear"),
                        ("attention.rpe", "attn/rpe", "rpe"),
                        ("mlp.fc1", "mlp_fc1", "linear"), ("mlp.fc2", "mlp_fc2", "linear"))],
    ("backbone.downsamples.{s}.conv", _B + "stage_down{s}_conv", "conv"),
    ("backbone.downsamples.{s}.norm", _B + "stage_down{s}_bn", "bn"),
    ("backbone.decoder.conv1x1.{s}", _B + "fpn_1x1_{s}", "linear"),
    ("backbone.decoder.conv3x3.{s}.conv", _B + "fpn_3x3_{s}/conv", "conv"),
    ("backbone.decoder.conv3x3.{s}.bn", _B + "fpn_3x3_{s}/bn", "bn"),
    ("backbone.decoder.up_conv.{s}.deconv", _B + "head_up{s}_conv", "conv"),
    ("backbone.decoder.up_conv.{s}.bn", _B + "head_up{s}_bn", "bn"),
    ("backbone.seg_head.0", _B + "head_fc1", "linear"),
    ("backbone.seg_head.1", _B + "head_bn", "bn"),
    ("backbone.seg_head.3", _B + "head_fc2", "linear"),
]

# OA-CNNs (the last projection of a block, ``proj.{S}``, is ``proj.last``
# in the rules: ``_oacnns_last_proj`` renames it)
_OACNNS_BLOCK = ("backbone.enc.{s}.blocks.{b}.", _B + "enc{s}_block{b}/")
_OACNNS_RULES = [
    *[(f"backbone.stem.{3 * i + r}", _B + f"stem{'_bn' if r else ''}{i}", "bn" if r else "conv")
      for i in range(3) for r in (0, 1)],
    ("backbone.enc.{s}.down.0", _B + "down{s}", "conv"),
    ("backbone.enc.{s}.down.1", _B + "down_bn{s}", "bn"),
    *[(_OACNNS_BLOCK[0] + tt, _OACNNS_BLOCK[1] + jt, k) for tt, jt, k in (
        ("l_w.{d}.0", "lw{d}_fc", "linear"), ("l_w.{d}.1", "lw{d}_bn", "bn"),
        ("weight.{d}", "weight{d}", "linear"),
        ("proj.{d}.0", "proj{d}_fc", "linear"), ("proj.{d}.1", "proj{d}_bn", "bn"),
        ("proj.last.0", "proj_last_fc", "linear"), ("proj.last.1", "proj_last_bn", "bn"),
        ("adaptive", "adaptive", "linear"),
        ("fuse.0", "fuse_fc", "linear"), ("fuse.1", "fuse_bn", "bn"),
        ("voxel_block.0", "conv1", "conv"), ("voxel_block.1", "bn1", "bn"),
        ("voxel_block.3", "conv2", "conv"), ("voxel_block.4", "bn2", "bn"))],
    ("backbone.dec.{s}.up.0", _B + "up{s}", "conv"),
    ("backbone.dec.{s}.up.1", _B + "up_bn{s}", "bn"),
    *[(f"backbone.dec.{{s}}.fuse.{3 * i + r}", _B + f"fuse{{s}}_{'bn' if r else 'fc'}{i + 1}",
       "bn" if r else "linear") for i in range(2) for r in (0, 1)],
    ("backbone.final", _B + "final", "linear"),
]

# (torch module path, JAX module path, kind)
RULES: List[Tuple[str, str, str]] = [
    ("backbone.enc{s}.0.linear", _B + "enc{s}/down/linear", "linear"),
    ("backbone.enc{s}.0.bn", _B + "enc{s}/down/bn", "bn"),
    ("backbone.dec{s}.0.linear1.0", _B + "dec{s}/up/linear1", "linear"),
    ("backbone.dec{s}.0.linear1.1", _B + "dec{s}/up/bn1", "bn"),
    ("backbone.dec{s}.0.linear2.0", _B + "dec{s}/up/linear2", "linear"),
    ("backbone.dec{s}.0.linear2.1", _B + "dec{s}/up/bn2", "bn"),
    *[(f"backbone.{{st}}{{s}}.{{i}}.{tt}", _B + f"{{st}}{{s}}/block{{j}}/{jt}", k)
      for tt, jt, k in _BLOCK_TAILS],
    ("backbone.cls.0", _B + "cls1", "linear"),
    ("backbone.cls.1", _B + "cls_bn", "bn"),
    ("backbone.cls.3", _B + "cls2", "linear"),
    ("dec{s}.linear1.0", "dec{s}/linear1", "linear"),
    ("dec{s}.linear1.1", "dec{s}/bn1", "bn"),
    ("dec{s}.linear2.0", "dec{s}/linear2", "linear"),
    ("dec{s}.linear2.1", "dec{s}/bn2", "bn"),
    ("conf.0", "conf1", "linear"),
    ("conf.1", "conf_bn", "bn"),
    ("conf.3", "conf2", "linear"),
    *_PTV2_RULES,
    *_SPUNET_RULES,
    *_PTV3_RULES,
    *_CAC_RULES,
    *_PPT_RULES,
    # PointGroup's heads (its backbone under the rules above)
    ("bias_head.0", "bias_fc1", "linear"),
    ("bias_head.1", "bias_bn", "bn"),
    ("bias_head.3", "bias_fc2", "linear"),
    *_ST_RULES,
]

_GROUPS = {"st": r"(?P<st>enc|dec)", "s": r"(?P<s>\d)", "b": r"(?P<b>\d+)",
           "i": r"(?P<i>\d+)",
           "j": r"(?P<j>\d+)", "d": r"(?P<d>\d+)", "k": r"(?P<k>\d)",
           "u": r"(?P<u>\d+)", "w": r"(?P<w>\d+)",
           "sl": r"(?P<sl>\d+)", "si": r"(?P<si>\d+)", "su": r"(?P<su>\d+)",
           "sw": r"(?P<sw>\d+)"}

# torch leaf -> (JAX collection, JAX leaf) per kind
_LEAVES = {
    "linear": {"weight": ("params", "kernel"), "bias": ("params", "bias")},
    "conv": {"weight": ("params", "kernel"), "bias": ("params", "bias")},
    "bn": {"weight": ("params", "scale"), "bias": ("params", "bias"),
           "running_mean": ("batch_stats", "mean"),
           "running_var": ("batch_stats", "var"),
           # a PDNorm's modulation (a JAX Dense under the norm's path)
           "modulation_weight": ("params", "modulation_kernel"),
           "modulation_bias": ("params", "modulation_bias")},
    "ln": {"weight": ("params", "scale"), "bias": ("params", "bias")},
    # a PDLayerNorm's banks stacked (``_stack_pd``) and its modulation
    "pdln": {"pd_weight": ("params", "scale"), "pd_bias": ("params", "bias"),
             "modulation_weight": ("params", "modulation_kernel"),
             "modulation_bias": ("params", "modulation_bias")},
    "rpe": {"rpe_table": ("params", "rpe_table")},
    "embed": {"weight": ("params", "embedding")},
    "crse": {f"{side}_{g}_table": ("params", f"{side}_{g}_table")
             for side in ("query", "key", "value") for g in ("xyz", "rgb", "norm")},
    "dwconv": {"weight": ("params", "kernel")},
    "tables": {f"relative_pos_{n}_table": ("params", f"rel_{n}_table")
               for n in ("query", "key", "value")},
    "kpconv": {"weight": ("params", "kp_weight"),
               "K_points": ("batch_stats", "kp_points")},
}
# PT-v2's BatchNorm under its ``PointBatchNorm`` wrapper's ``.norm``
_LEAVES["pointbn"] = _LEAVES["bn"]
_BN_KINDS = ("bn", "pointbn")


def _regex(template: str, sep: str) -> re.Pattern:
    parts = re.split(r"(\{\w+\})", template)
    seen, body = set(), []
    for p in parts:
        if not p.startswith("{"):
            body.append(re.escape(p))
        elif p[1:-1] in seen:       # a group named twice: the same text
            body.append(f"(?P={p[1:-1]})")
        else:
            seen.add(p[1:-1])
            body.append(_GROUPS[p[1:-1]])
    return re.compile("".join(body) + re.escape(sep) + r"(?P<leaf>\w+)")


_TORCH_RX = [(_regex(t, "."), j, k) for t, j, k in RULES]
_JAX_RX = [(_regex(j, "/"), t, k) for t, j, k in RULES]
# ``cls_bn`` and ``conf_bn`` name a module in the PT-v1 trees and in the ST
# trees: a tree that holds an ST-only module reads the ST rules first
_JAX_RX_ST = ([(_regex(j, "/"), t, k) for t, j, k in _ST_RULES]
              + _JAX_RX[:-len(_ST_RULES)])
_ST_ONLY = re.compile(r"(^|/)(stem_down|conf_fc1)/")
# Swin3D and OctFormer trees share names with the Stratified Transformer's
# and with each other's (``layers.{l}.blocks.{d}``, ``layer{i}_block{d}``):
# a tree of either reads its own rules alone
_FAMILIES = {
    "swin3d": (_SWIN3D_RULES, re.compile(r"attn\.(query|key|value)_(xyz|rgb|norm)_table$"),
               re.compile(r"attn/(query|key|value)_(xyz|rgb|norm)_table$")),
    "octformer": (_OCTFORMER_RULES, re.compile(r"^backbone\.decoder\.conv1x1\."),
                  re.compile(r"(^|/)fpn_1x1_0/")),
    "oacnns": (_OACNNS_RULES, re.compile(r"^backbone\.enc\.\d+\.blocks\.\d+\.l_w\."),
               re.compile(r"(^|/)enc\d+_block\d+/lw0_fc/")),
}
_FAMILY_TORCH_RX = {f: [(_regex(t, "."), j, k) for t, j, k in rules]
                    for f, (rules, _, _) in _FAMILIES.items()}
_FAMILY_JAX_RX = {f: [(_regex(j, "/"), t, k) for t, j, k in rules]
                  for f, (rules, _, _) in _FAMILIES.items()}
# a Swin3D stem is ``stem_layer`` itself, or its first module where a
# residual block and a downsample follow (layer start 1)
_SWIN3D_JAX_RX = {
    start: [r for r in _FAMILY_JAX_RX["swin3d"]
            if r[1] not in (("backbone.stem_layer.conv", "backbone.stem_layer.norm") if start
                            else ("backbone.stem_layer.0.conv", "backbone.stem_layer.0.norm"))]
    for start in (0, 1)}


def _family(keys, side: int):
    """The model family whose rules alone map these keys (``side`` 1: torch
    keys, 2: JAX paths), or None for the shared rules."""
    for name, spec in _FAMILIES.items():
        if any(spec[side].search(k) for k in keys):
            return name
    return None


def _swin3d_layout(keys, jax_side: bool):
    """(num_layers, layer start) of a Swin3D from its keys."""
    if jax_side:
        start = int(any(re.search(r"(^|/)stem_down/", k) for k in keys))
        top = max(int(m.group(1)) for m in (re.search(r"/layer(\d+)_block", k) for k in keys)
                  if m)
        return top + 1, start
    start = int(any(k.startswith("backbone.downsample.") for k in keys))
    top = max(int(m.group(1)) for m in (re.search(r"^backbone\.layers\.(\d+)\.", k)
                                        for k in keys) if m)
    return top + 1 + start, start


def _is_linear(kind: str, arr) -> bool:
    """Whether a weight of ``kind`` is a Linear's (transposed across the
    bridge): a "conv" rule's 2-D weight is one, its 3-D one a sparse conv's."""
    return kind == "linear" or (kind == "conv" and arr.ndim == 2)


def _fill(template: str, groups: Dict[str, str], num_layers: int,
          layer_start: int = 0) -> str:
    g = dict(groups)
    # Swin3D: layers from the layer start, upsamples from the deepest
    if g.get("si") is not None:
        g["sl"] = str(int(g["si"]) - layer_start)
    elif g.get("sl") is not None:
        g["si"] = str(int(g["sl"]) + layer_start)
    if g.get("sw") is not None:
        g["su"] = str(num_layers - 1 - int(g["sw"]))
    elif g.get("su") is not None:
        g["sw"] = str(num_layers - 1 - int(g["su"]))
    if g.get("i") is not None:
        g["j"] = str(int(g["i"]) - 1)
    elif g.get("j") is not None:
        g["i"] = str(int(g["j"]) + 1)
    # ST decoder: upsamples.{u} lifts layer num_layers-1-u; the JAX module
    # is named after that layer, and "up0" where it lands on the stem
    if g.get("u") is not None:
        w = num_layers - 1 - int(g["u"])
        g["w"] = "0" if w == 1 else str(w)
    elif g.get("w") is not None:
        w = int(g["w"])
        g["u"] = str(num_layers - 2 if w == 0 else num_layers - 1 - w)
    return re.sub(r"\{(\w+)\}", lambda m: g[m.group(1)], template)


def _st_num_layers(keys, pattern: str, offset: int) -> int:
    """``num_layers`` of a Stratified Transformer from its keys (0 for any
    other tree): the highest encoder layer index plus ``offset``."""
    found = [int(m.group(1)) for m in (re.search(pattern, k) for k in keys) if m]
    return max(found) + offset if found else 0


_OACNNS_BLOCK_KEY = re.compile(
    r"(?P<block>backbone\.enc\.\d+\.blocks\.\d+\.)(?P<part>l_w|proj)\.(?P<i>\d+|last)\."
    r"(?P<rest>.*)")


def _oacnns_last_proj(state_dict: Dict, to_last: bool) -> Dict:
    """An OA-CNNs block's last projection renamed: ``proj.{S}`` (S the
    block's scales, its count of ``l_w``) to the rules' ``proj.last``
    (``to_last``), or back."""
    scales: Dict[str, int] = {}
    for key in state_dict:
        m = _OACNNS_BLOCK_KEY.fullmatch(key)
        if m and m.group("part") == "l_w":
            scales[m.group("block")] = max(scales.get(m.group("block"), 0),
                                           int(m.group("i")) + 1)
    out = {}
    for key, value in state_dict.items():
        m = _OACNNS_BLOCK_KEY.fullmatch(key)
        if m and m.group("part") == "proj":
            last = str(scales[m.group("block")])
            if m.group("i") == (last if to_last else "last"):
                key = (f"{m.group('block')}proj.{'last' if to_last else last}."
                       f"{m.group('rest')}")
        out[key] = value
    return out


def jax_to_state_dict(tree: Dict) -> Dict[str, torch.Tensor]:
    """JAX ``{params, batch_stats}`` tree -> torch state_dict."""
    if "embedding_table" in tree.get("params", {}).get("backbone_module", {}):
        # a model over a PPT backbone (PointGroup over PPT-v1m1 in backbone
        # mode): the PPT's tree under ``backbone_module``, its state_dict
        # under ``backbone.``
        sd = jax_to_state_dict({coll: {k: v for k, v in tree.get(coll, {}).items()
                                       if k != "backbone_module"}
                                for coll in ("params", "batch_stats")})
        inner = jax_to_state_dict({coll: tree.get(coll, {}).get("backbone_module", {})
                                   for coll in ("params", "batch_stats")})
        sd.update({f"backbone.{k}": v for k, v in inner.items()})
        return sd
    sd: Dict[str, torch.Tensor] = {}
    paths = flatten_tree(tree.get("params", {}))
    num_layers = _st_num_layers(paths, r"backbone_module/layer(\d+)_block", 1)
    layer_start = 0
    family = _family(paths, 2)
    if family == "swin3d":
        num_layers, layer_start = _swin3d_layout(paths, jax_side=True)
    is_st = any(_ST_ONLY.search(k) for k in paths)
    rules = (_SWIN3D_JAX_RX[layer_start] if family == "swin3d" else _FAMILY_JAX_RX[family]
             if family else _JAX_RX_ST if is_st else _JAX_RX)
    root = {j: t for t, j in (*_ROOT_LEAVES.items(), *_PPT_ROOT_LEAVES.items())}
    for coll in ("params", "batch_stats"):
        for path, value in flatten_tree(tree.get(coll, {})).items():
            if f"{coll}/{path}" in root:
                sd[root[f"{coll}/{path}"]] = torch.from_numpy(np.array(value))
                continue
            path = _PD_MODULATION.sub(r"/modulation_\1", path)
            for rx, torch_tmpl, kind in rules:
                m = rx.fullmatch(path)
                if m is None:
                    continue
                leaf = next((tl for tl, (c, jl) in _LEAVES[kind].items()
                             if c == coll and jl == m.group("leaf")), None)
                if leaf is None:
                    continue
                mod = _fill(torch_tmpl, m.groupdict(), num_layers, layer_start)
                arr = np.asarray(value)
                if leaf == "modulation_weight" or (leaf == "weight" and _is_linear(kind, arr)):
                    arr = arr.T
                if kind in _BN_KINDS and (arr.ndim == 2 or leaf.startswith("modulation")):
                    _put_pd(sd, mod, leaf, arr, strip_norm=kind == "pointbn")
                    break
                if kind == "pdln":
                    _put_pd_ln(sd, mod, leaf, arr)
                    break
                sd[f"{mod}.{leaf}"] = torch.from_numpy(np.array(arr))
                if kind in _BN_KINDS:
                    sd[f"{mod}.num_batches_tracked"] = torch.tensor(0)
                break
            else:
                raise KeyError(f"bridge: no torch name for JAX leaf {coll}/{path}")
    return _oacnns_last_proj(sd, to_last=False) if family == "oacnns" else sd


# PDNorm (PT-v2m3, SpUNet-v1m3, PT-v3): the JAX Dense "modulation" under a
# norm's path, and a torch bank or modulation leaf under the norm's module:
# a PD BatchNorm's ``bns.{i}`` (``bn`` not decoupled), a PDLayerNorm's
# ``norm.{i}`` (``norm``)
_PD_MODULATION = re.compile(r"/modulation/(kernel|bias)$")
_PD_TORCH = re.compile(
    r"(?P<mod>.+)\.(?:bns\.(?P<bank>\d+)|bn|modulation\.1)\.(?P<leaf>\w+)")
_PD_LN_TORCH = re.compile(
    r"(?P<mod>.+)\.(?:norm\.(?P<bank>\d+)|norm|modulation\.1)\.(?P<leaf>\w+)")


def _put_pd(sd, mod, leaf, arr, strip_norm):
    """A PD norm's stacked JAX leaf -> its banks' (or modulation's) torch
    leaves; ``mod`` is the plain model's name of the BatchNorm: PT-v2m2's
    ``<X>.norm`` (``strip_norm``: the PD norm replaces ``<X>``), or SpUNet's
    and PT-v3's ``<X>``."""
    base = mod[:-len(".norm")] if strip_norm else mod
    if leaf.startswith("modulation"):
        sd[f"{base}.modulation.1.{leaf[len('modulation_'):]}"] = torch.from_numpy(
            np.array(arr))
        return
    for i, row in enumerate(arr):
        sd[f"{base}.bns.{i}.{leaf}"] = torch.from_numpy(np.array(row))
        sd[f"{base}.bns.{i}.num_batches_tracked"] = torch.tensor(0)


def _put_pd_ln(sd, mod, leaf, arr):
    """A PDLayerNorm's stacked JAX leaf -> its banks' ``<mod>.norm.{i}``
    (or modulation's) torch leaves."""
    if leaf.startswith("modulation"):
        sd[f"{mod}.modulation.1.{leaf[len('modulation_'):]}"] = torch.from_numpy(
            np.array(arr))
        return
    for i, row in enumerate(arr):
        sd[f"{mod}.norm.{i}.{leaf[len('pd_'):]}"] = torch.from_numpy(np.array(row))


def _pd_bn_name(base: str):
    """The plain model's name of the BatchNorm whose place the PD norm
    ``base`` takes (PT-v2m2's ``<base>.norm``, SpUNet's and PT-v3's
    ``<base>``), or None when ``base`` is no such place (its ``bns`` /
    ``bn`` / ``modulation`` child is then no PD norm's)."""
    for name, kind in ((f"{base}.norm", "pointbn"), (base, "bn")):
        key = f"{name}.running_mean"
        if any(k == kind and rx.fullmatch(key) for rx, _, k in _TORCH_RX):
            return name
    return None


def _is_ln_place(base: str) -> bool:
    """Whether ``base`` names a LayerNorm that a PDLayerNorm may take."""
    return any(k == "ln" and rx.fullmatch(f"{base}.weight") for rx, _, k in _TORCH_RX)


def _stack_pd(state_dict):
    """A state_dict with each PD norm's leaves in the plain model's names
    of its norm ``<N>``: a PD BatchNorm's banks stacked (``<N>.weight``
    (n_bank, C)), a PDLayerNorm's as ``<N>.pd_weight`` / ``pd_bias``, the
    modulation as ``<N>.modulation_weight`` / ``_bias``."""
    out, banks = {}, {}
    for key, value in state_dict.items():
        m = _PD_TORCH.fullmatch(key)
        name, prefix = (m and _pd_bn_name(m.group("mod"))), ""
        if not name:
            m = _PD_LN_TORCH.fullmatch(key)
            name, prefix = (m and _is_ln_place(m.group("mod")) and m.group("mod")), "pd_"
        if not name:
            out[key] = value
        elif ".modulation.1." in key:
            out[f"{name}.modulation_{m.group('leaf')}"] = value
        elif m.group("leaf") != "num_batches_tracked":
            bank = int(m.group("bank") or 0)
            banks.setdefault(f"{name}.{prefix}{m.group('leaf')}", {})[bank] = value
    for key, rows in banks.items():
        out[key] = torch.stack([rows[i] for i in sorted(rows)])
    return out


def state_dict_to_jax(state_dict: Dict[str, torch.Tensor]) -> Dict:
    """torch state_dict -> JAX ``{params, batch_stats}`` tree of numpy."""
    if any(k.startswith("backbone.embedding_table.") for k in state_dict):
        # a model over a PPT backbone (see ``jax_to_state_dict``)
        tree = state_dict_to_jax({k: v for k, v in state_dict.items()
                                  if not k.startswith("backbone.")})
        inner = state_dict_to_jax({k[len("backbone."):]: v for k, v in state_dict.items()
                                   if k.startswith("backbone.")})
        return {coll: dict(tree[coll], backbone_module=inner[coll]) for coll in tree}
    flat: Dict[str, np.ndarray] = {}
    num_layers = _st_num_layers(state_dict, r"backbone\.layers\.(\d+)\.", 2)
    layer_start = 0
    family = _family(state_dict, 1)
    if family == "swin3d":
        num_layers, layer_start = _swin3d_layout(state_dict, jax_side=False)
    elif family == "oacnns":
        state_dict = _oacnns_last_proj(state_dict, to_last=True)
    # CAC's prototypes are its ``seg_head``; DefaultSegmentorV2's is a Linear
    root = dict(_PPT_ROOT_LEAVES)
    if any(k.startswith("feat_proj_layer.") for k in state_dict):
        root.update(_ROOT_LEAVES)
    for key, value in (state_dict if family else _stack_pd(state_dict)).items():
        if key.endswith(".num_batches_tracked"):
            continue
        if key in root:   # np.array: a 0-d leaf (logit_scale) stays 0-d
            flat[root[key]] = np.array(value.detach().cpu().numpy())
            continue
        for rx, jax_tmpl, kind in (_FAMILY_TORCH_RX[family] if family else _TORCH_RX):
            m = rx.fullmatch(key)
            if m is None or m.group("leaf") not in _LEAVES[kind]:
                continue
            coll, jleaf = _LEAVES[kind][m.group("leaf")]
            arr = value.detach().cpu().numpy()
            if jleaf == "modulation_kernel" or (jleaf == "kernel" and _is_linear(kind, arr)):
                arr = arr.T
            path = _fill(jax_tmpl, m.groupdict(), num_layers, layer_start)
            jleaf = jleaf.replace("modulation_", "modulation/")
            flat[f"{coll}/{path}/{jleaf}"] = np.ascontiguousarray(arr)
            break
        else:
            raise KeyError(f"bridge: no JAX name for torch key {key}")
    tree = unflatten_tree(flat)
    return {"params": tree.get("params", {}),
            "batch_stats": tree.get("batch_stats", {})}


def backbone_state_dict_to_jax(state_dict: Dict[str, torch.Tensor]) -> Dict:
    """A bare backbone's state_dict (no ``backbone.`` prefix: the incremental
    learner's student) -> its JAX tree, the ``backbone_module`` subtree of a
    segmentor's."""
    tree = state_dict_to_jax({f"backbone.{k}": v for k, v in state_dict.items()})
    return {coll: tree[coll].get("backbone_module", {}) for coll in tree}


def jax_to_backbone_state_dict(tree: Dict) -> Dict[str, torch.Tensor]:
    """A bare backbone's JAX tree -> its state_dict (no ``backbone.``
    prefix)."""
    sd = jax_to_state_dict({coll: {"backbone_module": tree.get(coll, {})}
                            for coll in ("params", "batch_stats")})
    return {k[len("backbone."):]: v for k, v in sd.items()}
