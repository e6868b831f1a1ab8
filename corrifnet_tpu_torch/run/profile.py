"""Parameters, forward FLOPs and the train step's peak memory of a model.

Counterpart of ``corrifnet_tpu/run/profile.py`` (the reference's
calculate.py / calculate2.py / calculate3.py):

  * parameters: ``sum(p.numel() for p in model.parameters())``, buffers
    excluded (calculate3.py:168-172), equal to the JAX package's
    ``param_count`` of the same model;
  * FLOPs of one forward in evaluation mode: ``torch.utils.flop_counter.
    FlopCounterMode``, which counts the products of convolutions, matmuls
    and attention at PyTorch's operator level. It runs on the ``meta``
    device, where tensors carry shapes only, so the count takes no memory
    and no time to compute and is the same whichever ``--device`` is asked.
    There every kernel wrapper takes its plain version (``ops``): K1 and K2,
    which on the card run outside PyTorch's operators, are counted through
    the products of their plain formulas. XLA's ``cost_analysis``, the JAX
    package's number, also counts elementwise work, so the two are not
    equal;
  * ``--memory``: ``torch.cuda.max_memory_allocated()`` after
    ``reset_peak_memory_stats()`` around one training step (forward,
    backward, Adam; bf16 over f32 parameters, the config's default) at
    ``--batch-size`` on the card, under
    ``utils.determinism.deterministic()`` as ``run.main`` trains. The JAX
    package's number is XLA's buffer assignment of the compiled step, which
    has no counterpart on the CPU: there the peak is "not measured".

    python -m corrifnet_tpu_torch.run.profile MMVit4 [--batch-size 1]
        [--lim 224] [--memory] [--device cuda]

It prints the JAX package's line, ``MODEL: params P  flops F[  train-step
peak M]``, then one line naming how the FLOPs were counted.
"""

from __future__ import annotations

import argparse

import torch
from torch.utils.flop_counter import FlopCounterMode

from corrifnet_tpu_torch.models.registry import create_model, get_spec
from corrifnet_tpu_torch.nn import DropoutRng
from corrifnet_tpu_torch.run.evaluate import _DTYPES
from corrifnet_tpu_torch.train import init_state
from corrifnet_tpu_torch.train.state import make_train_step
from corrifnet_tpu_torch.utils.determinism import deterministic

__all__ = ["FLOP_PATH", "clever_format", "flops", "meta_model", "param_count", "profile_model",
           "sample_input", "train_step_memory", "training_step", "main"]

FLOP_PATH = ("flops: FlopCounterMode over one forward on the meta device (shapes only, the "
             "same count for every device); K1 and K2 through the products of their plain "
             "versions")


def param_count(model) -> int:
    """Trainable parameter count (calculate3.py:168-172)."""
    return sum(p.numel() for p in model.parameters())


def meta_model(modeltype: str, **options):
    """``modeltype`` built on the ``meta`` device in evaluation mode (no
    memory, no initialization); ``options`` as ``models.create_model``'s."""
    spec = get_spec(modeltype)
    with torch.device("meta"):
        model = spec.factory(dtype=torch.float32, transformer_dropout=0.0,
                             **{k: v for k, v in options.items() if k in spec.options})
    # a static buffer made from numpy is a CPU tensor whatever the context
    return model.to("meta").eval()


def sample_input(modeltype: str, batch_size: int = 1, lim: int = 224, device="meta"):
    """Zeros of the model's input shape: (B, 3, 3, lim, lim) for a 5-D
    model, (B, 3, lim, lim) for a 4-D one."""
    shape = (3, 3) if get_spec(modeltype).input_kind == "5d" else (3,)
    return torch.zeros((batch_size, *shape, lim, lim), device=device)


def flops(model, sample) -> int:
    """FLOPs of one forward of ``model`` on ``sample``, both on the ``meta``
    device (``meta_model``, ``sample_input``), in evaluation mode without
    gradients."""
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(sample)
    return int(counter.get_total_flops())


def clever_format(n: float, suffix="") -> str:
    """thop.clever_format-style human numbers (calculate.py:10)."""
    for unit, div in (("T", 1e12), ("G", 1e9), ("M", 1e6), ("K", 1e3)):
        if abs(n) >= div:
            return f"{n / div:.3f}{unit}{suffix}"
    return f"{n:.3f}{suffix}"


def training_step(modeltype: str, batch_size: int = 4, lim: int = 224, device="cuda",
                  dtype: str = "bfloat16", **options):
    """A function that runs one training step of ``modeltype`` (seed 0,
    ``dtype`` compute over f32 parameters, Adam, dropout keyed by seed 0) on
    random inputs on ``device`` and returns its (loss, jaccard, n_valid)."""
    with torch.no_grad():
        out_shape = meta_model(modeltype, **options)(
            sample_input(modeltype, batch_size, lim)).shape
    model = create_model(modeltype, dtype=_DTYPES[dtype], device=device, seed=0, **options)
    model.set_dropout_rng(DropoutRng(0, device))
    step = make_train_step(init_state(model, "Adam"))
    g = torch.Generator(device=device).manual_seed(0)
    images = torch.rand(sample_input(modeltype, batch_size, lim).shape, generator=g,
                        device=device)
    masks = (torch.rand(out_shape, generator=g, device=device) > 0.5).float()
    valid = torch.ones(batch_size, device=device)
    return lambda: step(images, masks, valid, 1e-4)


@deterministic()
def train_step_memory(modeltype: str, batch_size: int = 4, lim: int = 224, device="cuda",
                      dtype: str = "bfloat16", **options):
    """Peak device bytes of one ``training_step``, with the bytes allocated
    before and after it; None off the card."""
    if torch.device(device).type != "cuda":
        return None
    run = training_step(modeltype, batch_size, lim, device, dtype, **options)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    before = torch.cuda.memory_allocated(device)
    run()
    torch.cuda.synchronize(device)
    return {"peak_bytes": int(torch.cuda.max_memory_allocated(device)),
            "before_bytes": int(before),
            "after_bytes": int(torch.cuda.memory_allocated(device))}


def profile_model(modeltype: str, batch_size: int = 1, lim: int = 224, memory: bool = False,
                  device="cuda", dtype: str = "bfloat16", **options):
    """The parameter count and the FLOPs of a B=``batch_size`` forward at
    ``lim`` x ``lim``; with ``memory``, the train step's peak
    (``train_step_memory``, None off the card)."""
    model = meta_model(modeltype, **options)
    n_params = param_count(model)
    n_flops = flops(model, sample_input(modeltype, batch_size, lim))
    result = {
        "modeltype": modeltype,
        "params": n_params,
        "params_str": f"{n_params / 1e6:.3f}M",
        "flops": n_flops,
        "flops_str": clever_format(n_flops),
        "flop_path": FLOP_PATH,
    }
    if memory:
        mem = train_step_memory(modeltype, max(batch_size, 1), lim, device, dtype, **options)
        result["train_step_memory"] = mem
        result["train_peak_str"] = ("not measured" if mem is None
                                    else clever_format(mem["peak_bytes"], "B"))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("modeltype")
    ap.add_argument("--batch-size", type=int, default=1)
    ap.add_argument("--lim", type=int, default=224)
    ap.add_argument("--memory", action="store_true",
                    help="also run one training step on the card and report its peak "
                         "allocated bytes")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    r = profile_model(args.modeltype, args.batch_size, args.lim, memory=args.memory,
                      device=args.device)
    line = f"{r['modeltype']}: params {r['params_str']}  flops {r['flops_str']}"
    if args.memory:
        line += f"  train-step peak {r['train_peak_str']}"
    print(line)
    print(r["flop_path"])
    return r


if __name__ == "__main__":
    main()
