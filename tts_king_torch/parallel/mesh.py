"""The dp x tp mesh and the tensor-parallel sharding rules.

Counterpart of tts_king_tpu/parallel/mesh.py. A mesh spans the processes of
a ``torch.distributed`` run, one device a rank (``build_mesh`` after
``lockstep.initialize`` or torchrun): rank r sits at (r // tp, r % tp), tp
varying fastest, as JAX's ``np.asarray(devices).reshape(dp, tp)`` lays its
devices out, and the mesh holds a process group for each dp and each tp
line. Built from an explicit list of local devices, or in a process of no
run, a mesh is single-process: it holds one replica of a model per device
(data-parallel inference, pipeline.py), as JAX's single-process mesh does.

Tensor-parallel layout of the FFT blocks (Megatron-LM's column -> row):
  * attention q/k/v projections split over heads (their output features),
    the output projection ``fc`` split on its input features, its bias
    added once after the all-reduce;
  * the conv FFN's w_1 split on its 1024 filters (output channels), w_2 on
    its input channels, its bias added once after the all-reduce;
  * everything else (LayerNorm, BatchNorm, embeddings, predictors)
    replicated.
The rules name the port's state-dict keys and the torch dim each splits;
tests/test_torch_parallel_mesh.py holds them to JAX's PartitionSpecs
through weights.py's layouts. The HiFi-GAN table is JAX's, which no path
of the JAX package uses; nor does any path here.
"""

import re
import sys
from typing import Dict, Iterable, List, Optional

import torch
import torch.distributed as dist
from torch import nn

from tts_king_torch.parallel.comm import Axis, all_gather

DP_AXIS = "dp"
TP_AXIS = "tp"

# (regex on the state-dict key, torch dim split over tp); first match wins,
# no match is replicated.
FS2_TP_RULES = [
    (r"slf_attn\.w_[qkv]s\.weight$", 0),   # Linear (out = heads, in)
    (r"slf_attn\.w_[qkv]s\.bias$", 0),
    (r"slf_attn\.fc\.weight$", 1),         # Linear (out, in = heads)
    (r"pos_ffn\.w_1\.weight$", 0),         # Conv1d (out, in, k)
    (r"pos_ffn\.w_1\.bias$", 0),
    (r"pos_ffn\.w_2\.weight$", 1),
]

# HiFi-GAN generator: the wide conv stacks split on their channels.
HIFIGAN_TP_RULES = [
    (r"conv_pre\.(weight|v)$", 0),                        # (out, in, k)
    (r"conv_pre\.(bias|g)$", 0),
    (r"ups_\d+\.(weight|v)$", 0),                         # (in, out, k)
    (r"resblocks_\d+\.convs\d?_\d+\.(weight|v)$", 0),
    (r"resblocks_\d+\.convs\d?_\d+\.bias$", 0),
]


def spec_for(name: str, rules) -> Optional[int]:
    """The dim of ``name`` split over tp, or None (replicated)."""
    for pattern, dim in rules:
        if re.search(pattern, name):
            return dim
    return None


def fs2_param_specs(names: Iterable[str]) -> Dict[str, Optional[int]]:
    return {n: spec_for(n, FS2_TP_RULES) for n in names}


def hifigan_param_specs(names: Iterable[str]) -> Dict[str, Optional[int]]:
    return {n: spec_for(n, HIFIGAN_TP_RULES) for n in names}


class Mesh:
    """A (dp, tp) mesh. ``devices``: the device of each position, rank
    order, on a single-process mesh; None on a mesh of processes, whose
    ``rank`` is this process's place (None outside the mesh)."""

    def __init__(self, dp: int, tp: int, devices=None, rank=None,
                 dp_axis: Optional[Axis] = None,
                 tp_axis: Optional[Axis] = None):
        self.dp, self.tp = dp, tp
        self.devices = devices
        self.rank = rank
        self.dp_axis, self.tp_axis = dp_axis, tp_axis
        self._replicas = {}

    @property
    def shape(self) -> Dict[str, int]:
        return {DP_AXIS: self.dp, TP_AXIS: self.tp}

    @property
    def local(self) -> bool:
        return self.devices is not None

    def axis(self, name: str) -> Optional[Axis]:
        return {DP_AXIS: self.dp_axis, TP_AXIS: self.tp_axis}[name]

    def dp_devices(self) -> List[torch.device]:
        """A single-process mesh's device of each dp replica (tp index 0)."""
        return [self.devices[i * self.tp] for i in range(self.dp)]

    def replica(self, module: nn.Module, device) -> nn.Module:
        """``module`` itself on its own device, else one copy of it on
        ``device``, made once."""
        device = torch.device(device)
        own = next(module.parameters()).device
        if device == own:
            return module
        key = (id(module), device)
        if key not in self._replicas:
            import copy

            self._replicas[key] = copy.deepcopy(module).to(device)
        return self._replicas[key]


def rank_position(rank: int, tp: int):
    """(dp index, tp index) of ``rank``: tp varies fastest, as JAX's
    ``np.asarray(devices).reshape(dp, tp)``."""
    return divmod(rank, tp)


def _default_devices():
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def build_mesh(dp: int = -1, tp: int = 1, devices=None) -> Mesh:
    """Build a (dp, tp) mesh; dp=-1 uses all remaining devices. Over the
    ranks of the process group when one is joined and ``devices`` is None,
    else over ``devices`` (default: every local card, or the CPU).

    dp*tp may be smaller than the device count (an explicit sub-mesh is
    announced on stderr so nobody silently trains on a fraction of the
    machine); asking for more devices than exist fails with a clear error.
    """
    group_mesh = devices is None and dist.is_initialized()
    if not group_mesh:
        devices = [torch.device(d) for d in (
            devices if devices is not None else _default_devices())]
    n = dist.get_world_size() if group_mesh else len(devices)
    if dp == -1:
        if n % tp:
            raise ValueError(f"{n} devices not divisible by tp={tp}")
        dp = n // tp
    if dp * tp > n:
        raise ValueError(
            f"mesh dp={dp} x tp={tp} needs {dp * tp} devices but only "
            f"{n} are available")
    if dp * tp != n:
        sys.stderr.write(
            f"[mesh] note: dp={dp} x tp={tp} uses {dp * tp} of {n} "
            f"available devices\n")
    if not group_mesh:
        return Mesh(dp, tp, devices=devices[: dp * tp])

    # every rank creates every group, in one order (new_group's contract);
    # an axis of size 1 has no group, so no collective runs over it
    rank = dist.get_rank()
    positions = [rank_position(r, tp) for r in range(dp * tp)]

    def axis(size, lines):
        mine = None
        for ranks in lines:
            g = dist.new_group(ranks) if size > 1 else None
            if rank in ranks:
                mine = Axis(g, size, ranks.index(rank))
        return mine

    tp_axis = axis(tp, [[r for r, (a, _) in enumerate(positions) if a == i]
                        for i in range(dp)])    # the tp line of each dp index
    dp_axis = axis(dp, [[r for r, (_, b) in enumerate(positions) if b == j]
                        for j in range(tp)])    # the dp line of each tp index
    return Mesh(dp, tp, rank=rank if rank < dp * tp else None,
                dp_axis=dp_axis, tp_axis=tp_axis)


def note_one_card(device, what: str) -> None:
    """One process computes on one card: on a host of several, say so on
    stderr. JAX's single-process mesh spreads over every local device; here
    that takes one process a card (--distributed or torchrun), and a silent
    run on one card would cost the user the others' throughput."""
    device = torch.device(device)
    n = torch.cuda.device_count() if device.type == "cuda" else 0
    if n > 1:
        sys.stderr.write(
            f"[mesh] note: {what} runs in one process on {device}, one of "
            f"{n} cards; launch one process a card (--distributed or "
            f"torchrun) to train data-parallel on all of them\n")


def shard_tensor(t: torch.Tensor, dim: int, index: int, size: int):
    """Block ``index`` of ``size`` equal blocks of ``t`` along ``dim``."""
    n, rem = divmod(t.shape[dim], size)
    if rem:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"into {size} blocks")
    return t.narrow(dim, index * n, n)


def shard_state_dict(sd: Dict[str, torch.Tensor],
                     mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's slice of a full FastSpeech2 state dict (or Adam
    moments)."""
    tp = mesh.tp_axis
    if tp is None or tp.size == 1:
        return dict(sd)
    out = {}
    for k, v in sd.items():
        dim = spec_for(k, FS2_TP_RULES)
        out[k] = (v if dim is None
                  else shard_tensor(v, dim, tp.index, tp.size).contiguous())
    return out


def unshard_state_dict(sd: Dict[str, torch.Tensor],
                       mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The full tensors of a tp-sharded state dict, gathered over tp on
    every rank (each tp line gathers its own)."""
    tp = mesh.tp_axis
    if tp is None or tp.size == 1:
        return dict(sd)
    out = {}
    for k, v in sd.items():
        dim = spec_for(k, FS2_TP_RULES)
        out[k] = v if dim is None else torch.cat(all_gather(v, tp), dim)
    return out


def shard_batch(batch: Dict, mesh: Mesh, extra_leading_axis: bool = False):
    """This rank's contiguous row block of a global batch (counterpart of
    JAX's batch_specs / globalize_batch: rows over dp, the leading
    grad-accumulation axis of a superbatch replicated)."""
    dp = mesh.dp_axis
    if dp is None or dp.size == 1:
        return batch
    dim = 1 if extra_leading_axis else 0
    return {k: shard_tensor(v, dim, dp.index, dp.size)
            for k, v in batch.items()}


def set_dp_axis(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Give a FastSpeech2's modules that compute over the global batch the
    mesh's dp axis, in place: the dropouts (the global batch's mask), the
    BatchNorms (training statistics) and the variance adaptor (the CWT
    pitch's batch standardization, in training and at inference)."""
    from tts_king_torch.models.fs2 import VarianceAdaptor
    from tts_king_torch.models.layers import BatchNorm, Dropout

    dp = mesh.dp_axis or Axis()
    for m in model.modules():
        if isinstance(m, (Dropout, BatchNorm, VarianceAdaptor)):
            m.dp = dp
    return model


def shard_fs2(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Make a FastSpeech2 (meta or materialized) this rank's part of the
    mesh, in place: split the parameters the rules name, give the FFT
    blocks the tp axis, and the modules ``set_dp_axis`` names the dp
    axis."""
    from tts_king_torch.models.layers import (MultiHeadAttention,
                                              PositionwiseFeedForward)

    tp = mesh.tp_axis or Axis()
    if tp.size > 1:
        for name, p in list(model.named_parameters()):
            dim = spec_for(name, FS2_TP_RULES)
            if dim is None:
                continue
            owner, leaf = name.rsplit(".", 1)
            setattr(model.get_submodule(owner), leaf, nn.Parameter(
                shard_tensor(p.detach(), dim, tp.index, tp.size).clone()))
    for m in model.modules():
        if isinstance(m, MultiHeadAttention):
            if m.n_head % tp.size:
                raise ValueError(f"{m.n_head} heads do not split over "
                                 f"tp={tp.size}")
            m.tp = tp
            m.n_head //= tp.size
        elif isinstance(m, PositionwiseFeedForward):
            m.tp = tp
    return set_dp_axis(model, mesh)


def shard_train_state(state, mesh: Mesh):
    """Place a full TrainState on the mesh in place: the model by
    ``shard_fs2``, the Adam moments sliced by the same rules."""
    shard_fs2(state.model, mesh)
    opt = state.opt_state
    opt.mu = shard_state_dict(opt.mu, mesh)
    opt.nu = shard_state_dict(opt.nu, mesh)
    return state
