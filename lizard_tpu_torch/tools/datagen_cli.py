"""datagen CLI, the equivalent of tests/datagencli.c (the port of
lizard_tpu/tools/datagen_cli.py, the same bytes for the same arguments):
  python -m lizard_tpu_torch.tools.datagen_cli -g<size> -s<seed> -P<proba>
writes deterministic compressible data to stdout."""

import sys


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    size, seed, proba = 65536, 0, 0.70
    for arg in argv:
        if arg.startswith("-g"):
            v = arg[2:]
            mult = 1
            if v and v[-1] in "KMG":
                mult = {"K": 1 << 10, "M": 1 << 20, "G": 1 << 30}[v[-1]]
                v = v[:-1]
            size = int(float(v) * mult)
        elif arg.startswith("-s"):
            seed = int(arg[2:])
        elif arg.startswith("-P"):
            proba = int(arg[2:]) / 100.0
        elif arg in ("-h", "--help"):
            print(__doc__)
            return 0
        else:
            raise SystemExit(f"datagen: unknown arg {arg}")
    from lizard_tpu_torch.utils.datagen import gen
    sys.stdout.buffer.write(gen(size, seed=seed, proba=proba))
    return 0


if __name__ == "__main__":
    sys.exit(main())
