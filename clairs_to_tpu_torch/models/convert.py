# Port of clairs_to_tpu/models/convert.py and tools/convert_checkpoint.py::main.
"""Torch-checkpoint -> parameter conversion, and the one-time converter.

The reference ships whole-module torch pickles with keys ``model_acgt`` /
``model_nacgt`` (the reference's clairs/predict.py:512-568).  The functions
here map its state-dict names onto the JAX package's parameter layout
(numpy leaves), which ``models/checkpoint.py::params_from_jax`` turns into
this port's modules and ``save_checkpoint`` writes as the ``.npz`` both
packages load.  ``main`` is the converter of tools/convert_checkpoint.py,
under ``python -m clairs_to_tpu_torch convert_checkpoint``.
"""

import argparse
import sys
from dataclasses import asdict

import numpy as np

from clairs_to_tpu_torch.models.bigru import SNV_BIGRU_CONFIG, BiGRUConfig
from clairs_to_tpu_torch.models.cvt import SNV_CVT_CONFIG, CvTConfig


def _a(sd, key):
    return np.asarray(sd[key], np.float32)


def cvt_params_from_state_dict(sd, config: CvTConfig = SNV_CVT_CONFIG):
    """Map a torch CvT/CvT_Indel state_dict onto the CvT parameter tree.

    Torch module naming (model.py:150-384): layer{s}.0 = embed conv,
    layer{s}.1 = LayerNorm, layer{s}.2.layers.{d}.{0|1} = PreNorm(attn|ff);
    DepthWiseConv2d.net = [dw conv, BN, pw conv]; FeedForward.net indices 0,3.
    """
    stages = []
    for s in range(config.num_stages):
        L = f"layer{s + 1}"
        blocks = []
        for d in range(config.depths[s]):
            B = f"{L}.2.layers.{d}"

            def dwproj(name):
                return {
                    "dw_weight": _a(sd, f"{B}.0.fn.{name}.net.0.weight"),
                    "bn": {
                        "weight": _a(sd, f"{B}.0.fn.{name}.net.1.weight"),
                        "bias": _a(sd, f"{B}.0.fn.{name}.net.1.bias"),
                        "running_mean": _a(sd, f"{B}.0.fn.{name}.net.1.running_mean"),
                        "running_var": _a(sd, f"{B}.0.fn.{name}.net.1.running_var"),
                    },
                    "pw_weight": _a(sd, f"{B}.0.fn.{name}.net.2.weight"),
                }

            blocks.append(
                {
                    "attn_ln_g": _a(sd, f"{B}.0.norm.g"),
                    "attn_ln_b": _a(sd, f"{B}.0.norm.b"),
                    "attn": {
                        "to_q": dwproj("to_q"),
                        "to_kv": dwproj("to_kv"),
                        "out_weight": _a(sd, f"{B}.0.fn.to_out.0.weight"),
                        "out_bias": _a(sd, f"{B}.0.fn.to_out.0.bias"),
                    },
                    "ff_ln_g": _a(sd, f"{B}.1.norm.g"),
                    "ff_ln_b": _a(sd, f"{B}.1.norm.b"),
                    "ff": {
                        "w1": _a(sd, f"{B}.1.fn.net.0.weight"),
                        "b1": _a(sd, f"{B}.1.fn.net.0.bias"),
                        "w2": _a(sd, f"{B}.1.fn.net.3.weight"),
                        "b2": _a(sd, f"{B}.1.fn.net.3.bias"),
                    },
                }
            )
        stages.append(
            {
                "emb_weight": _a(sd, f"{L}.0.weight"),
                "emb_bias": _a(sd, f"{L}.0.bias"),
                "ln_g": _a(sd, f"{L}.1.g"),
                "ln_b": _a(sd, f"{L}.1.b"),
                "blocks": blocks,
            }
        )
    return {
        "stages": stages,
        "fc1": {"weight": _a(sd, "fc1.weight"), "bias": _a(sd, "fc1.bias")},
        "heads": {
            al: {
                "fc2": {"weight": _a(sd, f"{al}_fc2.weight"), "bias": _a(sd, f"{al}_fc2.bias")},
                "fc3": {"weight": _a(sd, f"{al}_fc3.weight"), "bias": _a(sd, f"{al}_fc3.bias")},
            }
            for al in config.alleles
        },
    }


def bigru_params_from_state_dict(sd, config: BiGRUConfig = SNV_BIGRU_CONFIG):
    """Map a torch BiGRU_NACGT(_Indel) state_dict onto the BiGRU parameter tree.

    Torch naming (model.py:387-560): lstm / lstm_2 are nn.GRU modules with
    weight_ih_l0[,_reverse] etc.; allele heads are n{a}_fc2 / n{a}_fc3.
    """

    def gru(name):
        return {
            "ih": {"weight": _a(sd, f"{name}.weight_ih_l0"), "bias": _a(sd, f"{name}.bias_ih_l0")},
            "hh": {"weight": _a(sd, f"{name}.weight_hh_l0"), "bias": _a(sd, f"{name}.bias_hh_l0")},
            "ih_reverse": {
                "weight": _a(sd, f"{name}.weight_ih_l0_reverse"),
                "bias": _a(sd, f"{name}.bias_ih_l0_reverse"),
            },
            "hh_reverse": {
                "weight": _a(sd, f"{name}.weight_hh_l0_reverse"),
                "bias": _a(sd, f"{name}.bias_hh_l0_reverse"),
            },
        }

    return {
        "gru1": gru("lstm"),
        "gru2": gru("lstm_2"),
        "fc1": {"weight": _a(sd, "fc1.weight"), "bias": _a(sd, "fc1.bias")},
        "heads": {
            al: {
                "fc2": {
                    "weight": _a(sd, f"n{al}_fc2.weight"),
                    "bias": _a(sd, f"n{al}_fc2.bias"),
                },
                "fc3": {
                    "weight": _a(sd, f"n{al}_fc3.weight"),
                    "bias": _a(sd, f"n{al}_fc3.bias"),
                },
            }
            for al in config.alleles
        },
    }


def load_npz_state_dict(path):
    """Load an .npz state dict (names as in the reference) into a dict."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def main(argv=None):
    """Reference torch checkpoint -> ``.npz`` checkpoint.

    ``--torch_pkl`` holds a whole-module pickle, a dict with the module under
    ``model_acgt`` (aff) / ``model_nacgt`` (neg), or a plain state dict."""
    import torch

    from clairs_to_tpu_torch.models import mode_configs
    from clairs_to_tpu_torch.models.checkpoint import save_checkpoint

    p = argparse.ArgumentParser(prog="convert_checkpoint", description=main.__doc__)
    p.add_argument("--torch_pkl", required=True, help="reference .pkl checkpoint")
    p.add_argument("--kind", required=True, choices=["aff", "neg"])
    p.add_argument("--mode", default="snv", choices=["snv", "indel"])
    p.add_argument("--output", required=True, help=".npz output path")
    args = p.parse_args(argv)

    # a whole-module pickle needs the unpickler to build the module
    saved = torch.load(args.torch_pkl, map_location="cpu", weights_only=False)
    key = "model_acgt" if args.kind == "aff" else "model_nacgt"
    module = saved[key] if isinstance(saved, dict) and key in saved else saved
    state = module.state_dict() if hasattr(module, "state_dict") else module
    sd = {k: v.detach().cpu().numpy() for k, v in state.items()}

    cvt_config, bigru_config = mode_configs(args.mode)
    if args.kind == "aff":
        config = cvt_config
        params = cvt_params_from_state_dict(sd, config)
    else:
        config = bigru_config
        params = bigru_params_from_state_dict(sd, config)

    save_checkpoint(args.output, params, arch=asdict(config))
    print(f"[INFO] wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
