"""Inception-V3 (port of ``repro/models/inception.py``; Szegedy et al. 2015),
the paper's branchy-CNN model: stem, 3x InceptionA, the B reduction, 4x
InceptionC, the D reduction, 2x InceptionE, a global average pool and a
fully connected head.

The JAX layouts are kept, so the interop is a pure renaming: images are NHWC
(B, H, W, 3) and each conv's weight is HWIO (kh, kw, cin, cout) beside a
folded batch norm, trainable ``scale`` and ``bias`` (cout,) with no running
statistics, so train and eval are one function.  ``conv_bn`` hands
``F.conv2d`` the NHWC activation as its NCHW view (channels-last strides,
which cuDNN takes without a copy) and the weight as OIHW; the JAX package
computes its convolutions outside any Pallas kernel
(``jax.lax.conv_general_dilated``), so the library call is their
counterpart.  Pools, concatenation and the head are plain ops too.

Under a tensor-MP ``ParallelCtx`` each conv whose output channels the
model axis divides is column-parallel and ``head.fc`` class-sharded, as
JAX's sharding rules lay them out (HWIO dim 3, the classes); a conv the
axis does not divide (80 or 1000 at 32) is replicated with the rules'
warning and computed whole.

Two JAX quirks are copied: ``_inception_e`` gives the 1x3 and 3x1 siblings
their own 1x1 convs (6 branches, not one shared 1x1), and the reduced
block table (blocks a, b, e) is picked by ``cfg.n_layers <= 3``
(``is_reduced``).
``inception_dfg`` is the block-level dataflow graph of the paper's §6
DLPlacer case study.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.parallel import collectives as CL


def conv_init(gen: torch.Generator, kh: int, kw: int, cin: int, cout: int, *,
              dtype=torch.float32, device=None):
    w = torch.randn((kh, kw, cin, cout), generator=gen, dtype=torch.float32, device=device)
    return {"w": w.mul_(1.0 / math.sqrt(kh * kw * cin)).to(dtype),
            "scale": torch.ones((cout,), dtype=torch.float32, device=device),
            "bias": torch.zeros((cout,), dtype=torch.float32, device=device)}


def _padding(k: tuple, stride: int, padding: str):
    """JAX's "VALID" (none) or "SAME" at stride 1 over odd kernels (k // 2
    on each side); the model uses nothing else."""
    if padding == "VALID":
        return 0
    if padding == "SAME" and stride == 1 and all(n % 2 for n in k):
        return tuple(n // 2 for n in k)
    raise ValueError(f"padding {padding!r} at stride {stride} over a {k} window is not "
                     f"supported: only VALID, or SAME at stride 1 over odd windows")


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def conv_bn(p, x, stride: int = 1, padding: str = "SAME", pctx=None):
    """x (B, H, W, cin) -> relu(conv(x, w) * scale + bias) (B, H', W', cout).

    Under a tensor ctx whose rules shard ``w``'s output channels (HWIO dim 3;
    ``scale`` and ``bias`` stay whole), the conv is column-parallel: the
    replicated input enters through ``copy_to_model``, this rank computes
    its channels, and they leave through ``gather_from_model(-1)``."""
    w, scale, bias = p["w"], p["scale"], p["bias"]
    sharded = pctx is not None and w.shape[3] != scale.shape[0]
    if sharded:
        mesh, axis = pctx.mesh, pctx.model_axis
        n = w.shape[3]
        lo = mesh.ring(axis)[0] * n
        x = CL.copy_to_model(x, mesh, axis)
        scale = CL.copy_to_model(scale, mesh, axis).narrow(0, lo, n)
        bias = CL.copy_to_model(bias, mesh, axis).narrow(0, lo, n)
    w = w.to(x.dtype).permute(3, 2, 0, 1)                          # HWIO -> OIHW
    y = _nhwc(F.conv2d(_nchw(x), w, stride=stride,
                       padding=_padding(tuple(w.shape[2:]), stride, padding)))
    y = torch.relu(y * scale.to(x.dtype) + bias.to(x.dtype))
    return CL.gather_from_model(y, mesh, -1, axis) if sharded else y


def pool(x, kind: str, k: int = 3, stride: int = 1, padding: str = "SAME"):
    """Max or average pool of NHWC ``x``; the average under "SAME" divides
    by the number of in-image elements, as JAX's window sum of ones does."""
    pad = _padding((k, k), stride, padding)
    if kind == "max":
        y = F.max_pool2d(_nchw(x), k, stride, padding=pad)
    else:
        # on a contiguous NCHW copy: the CUDA backward of avg_pool2d over a
        # channels-last input is wrong in torch 2.11 (off by O(1) against
        # the CPU at (4, 160, 17, 17), k 3, stride 1, padding 1)
        y = F.avg_pool2d(_nchw(x).contiguous(), k, stride, padding=pad,
                         count_include_pad=False)
    return _nhwc(y)


# Block specs: list of branches; each branch = list of (kh, kw, cout, stride).
def _inception_a(cin, pool_ch):
    return [[(1, 1, 64, 1)],
            [(1, 1, 48, 1), (5, 5, 64, 1)],
            [(1, 1, 64, 1), (3, 3, 96, 1), (3, 3, 96, 1)],
            [("avgpool",), (1, 1, pool_ch, 1)]]


def _inception_b(cin):  # grid reduction 35->17
    return [[(3, 3, 384, 2)],
            [(1, 1, 64, 1), (3, 3, 96, 1), (3, 3, 96, 2)],
            [("maxpool2",)]]


def _inception_c(cin, c7):
    return [[(1, 1, 192, 1)],
            [(1, 1, c7, 1), (1, 7, c7, 1), (7, 1, 192, 1)],
            [(1, 1, c7, 1), (7, 1, c7, 1), (1, 7, c7, 1), (7, 1, c7, 1), (1, 7, 192, 1)],
            [("avgpool",), (1, 1, 192, 1)]]


def _inception_d(cin):  # grid reduction 17->8
    return [[(1, 1, 192, 1), (3, 3, 320, 2)],
            [(1, 1, 192, 1), (1, 7, 192, 1), (7, 1, 192, 1), (3, 3, 192, 2)],
            [("maxpool2",)]]


def _inception_e(cin):
    return [[(1, 1, 320, 1)],
            [(1, 1, 384, 1), (1, 3, 384, 1)],   # the 1x3 and 3x1 siblings each
            [(1, 1, 384, 1), (3, 1, 384, 1)],   # have their own 1x1, as in JAX
            [(1, 1, 448, 1), (3, 3, 384, 1), (1, 3, 384, 1)],
            [(1, 1, 448, 1), (3, 3, 384, 1), (3, 1, 384, 1)],
            [("avgpool",), (1, 1, 192, 1)]]


def is_reduced(cfg) -> bool:
    """The reduced block table (a, b, e) for a config of at most 3 layers,
    as JAX's ``build_model`` picks it."""
    return cfg.n_layers <= 3


def _blocks(reduced: bool):
    if reduced:
        return [("a", _inception_a(192, 32)), ("b", _inception_b(256)),
                ("e", _inception_e(768))]
    return [
        ("a", _inception_a(192, 32)), ("a", _inception_a(256, 64)),
        ("a", _inception_a(288, 64)),
        ("b", _inception_b(288)),
        ("c", _inception_c(768, 128)), ("c", _inception_c(768, 160)),
        ("c", _inception_c(768, 160)), ("c", _inception_c(768, 192)),
        ("d", _inception_d(768)),
        ("e", _inception_e(1280)), ("e", _inception_e(2048)),
    ]


def _out_channels(spec, cin):
    total = 0
    for branch in spec:
        convs = [op for op in branch if not isinstance(op[0], str)]
        total += convs[-1][2] if convs else cin      # a pool-only branch keeps cin
    return total


STEM = [(3, 3, 3, 32), (3, 3, 32, 32), (3, 3, 32, 64), (1, 1, 64, 80), (3, 3, 80, 192)]


def conv_shapes(reduced: bool = False):
    """The (kh, kw, cin, cout) of every conv in the parameter tree's layout:
    (the stem's list, ``blocks[b][branch][op]`` with an empty list for a
    pool-only branch, the head's input width)."""
    blocks, cin = [], STEM[-1][3]
    for _, spec in _blocks(reduced):
        branches = []
        for branch in spec:
            ops, c = [], cin
            for kh, kw, cout, _ in (op for op in branch if not isinstance(op[0], str)):
                ops.append((kh, kw, c, cout))
                c = cout
            branches.append(ops)
        blocks.append(branches)
        cin = _out_channels(spec, cin)
    return STEM, blocks, cin


def inception_init(gen: torch.Generator, cfg, *, reduced: bool = False, device=None):
    """Random parameters at the JAX init's scales, drawn from ``gen`` in the
    JAX order: ``stem`` (5 convs), ``blocks[b][branch][op]`` and ``head.fc``
    (cin, n_classes)."""
    dtype = getattr(torch, cfg.param_dtype)
    stem, blocks, cin = conv_shapes(reduced)

    def conv(shape):
        return conv_init(gen, *shape, dtype=dtype, device=device)

    params = {"stem": [conv(s) for s in stem],
              "blocks": [[[conv(s) for s in ops] for ops in branches] for branches in blocks]}
    fc = torch.randn((cin, cfg.vocab_size), generator=gen, dtype=torch.float32, device=device)
    params["head"] = {"fc": fc.mul_(0.01).to(dtype)}
    return params


def inception_block(spec, branches, x, pctx=None):
    """One block: each branch of ``spec`` (its convs' parameters in
    ``branches``) over NHWC ``x``, concatenated on the channels.  Stride-2
    convs are "VALID", all others "SAME"."""
    outs = []
    for branch_spec, branch in zip(spec, branches, strict=True):
        y = x
        convs = iter(branch)
        for op in branch_spec:
            if op[0] == "avgpool":
                y = pool(y, "avg", 3, 1, "SAME")
            elif op[0] == "maxpool2":                  # grid reduction
                y = pool(y, "max", 3, 2, "VALID")
            else:
                stride = op[3]
                y = conv_bn(next(convs), y, stride=stride,
                            padding="VALID" if stride == 2 else "SAME", pctx=pctx)
        outs.append(y)
    return torch.cat(outs, dim=-1)


def inception_forward(cfg, params, batch, reduced: bool = False, pctx=None):
    """batch: dict(images (B, H, W, 3)) -> logits (B, n_classes).  Under a
    tensor ctx (``pctx``) ``params`` is this rank's part: the sharded convs
    are column-parallel (``conv_bn``) and a class-sharded ``head.fc``'s
    logits are gathered; every other op runs whole on every rank."""
    x = batch["images"].to(getattr(torch, cfg.dtype))
    p = params["stem"]
    x = conv_bn(p[0], x, stride=2, padding="VALID", pctx=pctx)
    x = conv_bn(p[1], x, padding="VALID", pctx=pctx)
    x = conv_bn(p[2], x, pctx=pctx)
    x = pool(x, "max", 3, 2, "VALID")
    x = conv_bn(p[3], x, padding="VALID", pctx=pctx)
    x = conv_bn(p[4], x, padding="VALID", pctx=pctx)
    x = pool(x, "max", 3, 2, "VALID")
    for (_, spec), branches in zip(_blocks(reduced), params["blocks"], strict=True):
        x = inception_block(spec, branches, x, pctx=pctx)
    x = x.mean(dim=(1, 2))
    fc = params["head"]["fc"]
    if pctx is None or fc.shape[1] == cfg.vocab_size:
        return x @ fc.to(x.dtype)
    mesh, axis = pctx.mesh, pctx.model_axis
    return CL.gather_from_model(CL.copy_to_model(x, mesh, axis) @ fc.to(x.dtype), mesh, -1,
                                axis)


# ---------------------------------------------------------------------------
# DFG export for DLPlacer (the paper's §6 case study)
# ---------------------------------------------------------------------------

def inception_dfg(image_size: int = 299, batch: int = 32):
    """Block-level DFG with analytic per-op costs: DLPlacer's input.

    Returns (nodes, edges): nodes = {name: dict(flops, bytes_out, mem)};
    edges = [(src, dst)].  Grid sizes follow the standard V3 schedule
    (299 -> 35x35x288 -> 17x17x768 -> 8x8x2048), whatever ``image_size``.
    """
    nodes, edges = {}, []

    def add(name, flops, bytes_out, deps):
        nodes[name] = {"flops": float(flops), "bytes_out": float(bytes_out),
                       "mem": float(bytes_out)}
        for d in deps:
            edges.append((d, name))

    add("stem", 2 * 3.3e9 * batch / 32, batch * 35 * 35 * 192 * 4, [])
    prev = "stem"
    grid = {"a": (35, 288), "b": (17, 768), "c": (17, 768), "d": (8, 1280),
            "e": (8, 2048)}
    block_cin = {"a": 288, "b": 768, "c": 768, "d": 1280, "e": 2048}
    for bi, (kind, spec) in enumerate(_blocks(reduced=False)):
        g, cout_total = grid[kind]
        branch_names = []
        for j, branch in enumerate(spec):
            flops = 0.0
            c = block_cin[kind]
            for op in branch:
                if isinstance(op[0], str):
                    continue
                kh, kw, cout, _ = op
                flops += 2 * kh * kw * c * cout * g * g * batch
                c = cout
            name = f"blk{bi}_{kind}{j}"
            add(name, flops, batch * g * g * c * 4, [prev])
            branch_names.append(name)
        concat = f"blk{bi}_concat"
        add(concat, batch * g * g * cout_total, batch * g * g * cout_total * 4, branch_names)
        prev = concat
    add("head", 2 * 2048 * 1000 * batch, batch * 1000 * 4, [prev])
    return nodes, edges
