"""Weight bridge between flax variable trees and the port's state dicts.

The port's modules carry the flax module names, so a flax path maps onto a
state-dict key by joining it with dots and renaming the leaf; the arrays
change layout as follows:

    flax                                        torch
    Dense kernel (in, out)                      Linear weight (out, in)
    nn.Conv / TorchConv1d kernel (k, in, out)   Conv1d weight (out, in, k)
    TorchConvTranspose1d kernel (k, Cin, Cout)  ConvTranspose1d weight
                                                (Cin, Cout, k), not flipped
    nn.Embed embedding                          weight
    LayerNorm / BatchNorm scale, bias           weight, bias
    batch_stats mean, var                       running_mean, running_var
    weight-norm v, g (Generator, WNConv)        v, g: v in the layout of
                                                the conv's weight above; a
                                                2-D conv's (kh, kw, in, out)
                                                as (out, in, kh, kw)
    SNConv weight_orig                          weight_orig, laid out as v
    spectral u, v (SNConv's power iteration)    u, v buffers of the SNConv

The JAX package's transposed conv flips its kernel internally
(ops/convs.py:33-59); torch's ConvTranspose1d takes the same (k, Cin, Cout)
orientation without a flip. The transposed convs are the upsamplers, named
``ups_<i>`` in HiFi-GAN and ``up_<i>`` in MelGAN.

A weight-norm g is one value per output channel of a conv and per input
channel of a transposed conv, in both packages. ``optax_adam_to_torch``
reads the Adam moments out of an optax chain's state (adamw's
``ScaleByAdamState``), as ``flax_adam_to_torch`` reads them out of Adam's.

No JAX here: trees are nested dicts of numpy arrays (or anything
``np.asarray`` takes), and ``load_flax_npz`` reads the flat
``var::<collection>::a/b/c`` naming of the committed fixtures.
"""

import numpy as np
import torch

_TRANSPOSED_CONV_PREFIXES = ("ups_", "up_")


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if hasattr(value, "items"):
            yield from _flatten(value, prefix + (str(key),))
        else:
            yield prefix + (str(key),), value


def _is_transposed(path):
    return len(path) >= 2 and path[-2].startswith(_TRANSPOSED_CONV_PREFIXES)


def _kernel_to_torch(a, path):
    """A flax conv/dense kernel (or weight-norm v, weight_orig) in the
    layout of the torch weight."""
    if a.ndim == 2:
        return a.T
    if a.ndim == 3:
        return a.transpose((1, 2, 0) if _is_transposed(path) else (2, 1, 0))
    if a.ndim == 4:
        return a.transpose(3, 2, 0, 1)
    raise ValueError(f"kernel of rank {a.ndim} at {path}")


def _kernel_to_flax(a, path):
    """Inverse of _kernel_to_torch for a conv (rank 3 or 4)."""
    if a.ndim == 3:
        return a.transpose((2, 0, 1) if _is_transposed(path) else (2, 1, 0))
    return a.transpose(2, 3, 1, 0)


def flax_to_torch(variables):
    """{"params": tree, "batch_stats": tree, "spectral": tree} -> {state-dict
    key: tensor}."""
    sd = {}
    for coll, tree in variables.items():
        for path, leaf in _flatten(tree):
            a = np.asarray(leaf)
            name, mod = path[-1], ".".join(path[:-1])
            if coll == "params":
                if name == "kernel":
                    a, name = _kernel_to_torch(a, path), "weight"
                elif name in ("v", "weight_orig"):
                    a = _kernel_to_torch(a, path)
                elif name in ("embedding", "scale"):
                    name = "weight"
                elif name not in ("bias", "g"):
                    raise KeyError(f"unknown flax param {'/'.join(path)}")
            elif coll == "batch_stats":
                names = {"mean": "running_mean", "var": "running_var"}
                if name not in names:
                    raise KeyError(f"unknown batch stat {'/'.join(path)}")
                name = names[name]
            elif coll == "spectral":
                if name not in ("u", "v"):
                    raise KeyError(f"unknown spectral buffer "
                                   f"{'/'.join(path)}")
            else:
                raise KeyError(f"unknown flax collection {coll!r}")
            sd[f"{mod}.{name}"] = torch.from_numpy(np.ascontiguousarray(a))
    return sd


def flax_adam_to_torch(count, mu, nu):
    """optax's Adam state (``ScaleByAdamState`` count, mu, nu; mu and nu are
    trees in the flax params layout) -> the port's Adam state
    (train/state.AdamState), the moments keyed by state-dict name and laid
    out as the parameters they belong to."""
    from tts_king_torch.train.state import AdamState

    return AdamState(int(np.asarray(count)),
                     flax_to_torch({"params": mu}),
                     flax_to_torch({"params": nu}))


def optax_adam_to_torch(opt_state):
    """The Adam moments of an optax state (optax.adam's or a chain's, such
    as optax.adamw's: the element with ``count``, ``mu`` and ``nu``) -> the
    port's AdamState, as flax_adam_to_torch."""
    states = opt_state if isinstance(opt_state, (tuple, list)) else (
        opt_state,)
    for st in states:
        if all(hasattr(st, a) for a in ("count", "mu", "nu")):
            return flax_adam_to_torch(st.count, st.mu, st.nu)
    raise ValueError("no Adam state (count, mu, nu) in the optax state")


def torch_to_flax(state_dict):
    """Inverse of ``flax_to_torch``: a state dict (tensors or arrays) ->
    {"params": tree, "batch_stats": tree, "spectral": tree} of numpy arrays
    (the collections that have entries). Conv weights are told from Linear
    ones by rank; an SNConv's ``u`` and ``v`` (beside its ``weight_orig``)
    go to "spectral"; ``num_batches_tracked`` is dropped."""
    out = {"params": {}, "batch_stats": {}, "spectral": {}}
    spectral_mods = {k.rsplit(".", 1)[0] for k in state_dict
                     if k.endswith(".weight_orig")}
    for key, value in state_dict.items():
        a = np.asarray(value.detach().cpu().float().numpy()
                       if isinstance(value, torch.Tensor) else value)
        mod, name = key.rsplit(".", 1)
        path = tuple(mod.split("."))
        if name == "num_batches_tracked":
            continue
        coll = "params"
        if name in ("running_mean", "running_var"):
            coll, name = "batch_stats", name[len("running_"):]
        elif mod in spectral_mods and name in ("u", "v"):
            coll = "spectral"
        elif name in ("v", "weight_orig"):
            a = _kernel_to_flax(a, path + (name,))
        elif name == "weight":
            if path[-1].endswith(("emb", "embedding")):
                name = "embedding"
            elif a.ndim == 1:       # LayerNorm / BatchNorm
                name = "scale"
            elif a.ndim == 2:       # Linear
                a, name = a.T, "kernel"
            else:
                a, name = _kernel_to_flax(a, path + (name,)), "kernel"
        node = out[coll]
        for p in path:
            node = node.setdefault(p, {})
        node[name] = np.ascontiguousarray(a)
    return {c: t for c, t in out.items() if t or c == "params"}


def load_flax_npz(path):
    """Read a flat npz into a nested flax-style tree. Keys
    ``var::<collection>::a/b/c`` go to that collection; ``param:a/b/c`` (the
    trained-vocoder fixture's naming) to "params"; other keys are ignored."""
    z = np.load(path)
    out = {}
    for key in z.files:
        if key.startswith("var::"):
            _, coll, p = key.split("::", 2)
        elif key.startswith("param:"):
            coll, p = "params", key[len("param:"):]
        else:
            continue
        node = out.setdefault(coll, {})
        parts = p.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = z[key]
    return out


def load_into(module, state_dict):
    """Copy a state dict into ``module``. Every parameter and running stat
    must be given; only BatchNorm's ``num_batches_tracked`` counters may be
    missing (they are set to 0)."""
    own = module.state_dict()
    unexpected = sorted(set(state_dict) - set(own))
    missing = sorted(k for k in set(own) - set(state_dict)
                     if not k.endswith("num_batches_tracked"))
    if unexpected or missing:
        raise KeyError(f"state dict mismatch: missing {missing[:8]}, "
                       f"unexpected {unexpected[:8]}")
    full = dict(state_dict)
    for k in own:
        if k not in full:
            full[k] = torch.zeros((), dtype=torch.long)
    for k, v in full.items():
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"{k}: shape {tuple(v.shape)} vs module "
                             f"{tuple(own[k].shape)}")
    module.load_state_dict(full, strict=True)
    return module


def seeded_state_dict(module, seed=0):
    """Random weights for ``module`` from a numpy RandomState: conv/linear
    weights N(0, 1/fan_in), embeddings N(0, 0.3^2), norm scales 1 + N(0,
    0.1^2), biases and shifts N(0, 0.02^2), running stats mean N(0, 0.1^2)
    and var 1 + |N(0, 0.1^2)|, BigVGAN's log-scale alpha and beta N(0,
    0.1^2). Shapes only are read from ``module``, so a
    module built on the meta device will do."""
    rng = np.random.RandomState(seed)
    sd = {}
    for key, ref in module.state_dict().items():
        shape = tuple(ref.shape)
        name = key.rsplit(".", 1)[-1]
        if name == "num_batches_tracked":
            continue
        if name == "running_mean":
            a = 0.1 * rng.standard_normal(shape)
        elif name == "running_var":
            a = 1.0 + np.abs(0.1 * rng.standard_normal(shape))
        elif name == "bias":
            a = 0.02 * rng.standard_normal(shape)
        elif name in ("alpha", "beta"):
            # BigVGAN's log-scale SnakeBeta parameters, near their 0
            a = 0.1 * rng.standard_normal(shape)
        elif len(shape) == 1:
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif "emb" in key:
            a = 0.3 * rng.standard_normal(shape)
        else:
            fan_in = int(np.prod(shape)) // shape[0]
            if _is_transposed(tuple(key.split("."))):
                # ConvTranspose1d (Cin, Cout, k) with k = 2 * stride: each
                # output sees 2 taps of every input channel
                fan_in = 2 * shape[0]
            a = rng.standard_normal(shape) / np.sqrt(fan_in)
        sd[key] = torch.from_numpy(a.astype(np.float32))
    return sd
