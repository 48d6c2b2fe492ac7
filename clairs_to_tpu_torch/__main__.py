"""Submodule dispatcher: ``python -m clairs_to_tpu_torch <submodule> [options]``.

Counterpart of clairs_to_tpu/__main__.py.  The port has one submodule so
far, ``run``; the others (serve, train, compare_vcf, ...) are still to port.
"""

import sys

SUBMODULES = {}


def register(name):
    def deco(fn):
        SUBMODULES[name] = fn
        return fn
    return deco


@register("run")
def _run(argv):
    from clairs_to_tpu_torch.cli.run import main
    return main(argv)


def main():
    if len(sys.argv) < 2 or sys.argv[1] in ("-h", "--help"):
        print("Usage: python -m clairs_to_tpu_torch <submodule> [options]")
        print("Available submodules:\n  " + "\n  ".join(sorted(SUBMODULES)))
        return 0 if len(sys.argv) >= 2 else 1
    name = sys.argv[1]
    if name not in SUBMODULES:
        print(f"[ERROR] Unknown submodule {name!r}. Available: {sorted(SUBMODULES)}")
        return 1
    return SUBMODULES[name](sys.argv[2:]) or 0


if __name__ == "__main__":
    sys.exit(main())
