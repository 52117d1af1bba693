"""``python -m distributedpytorch_tpu_torch serve ...`` → the serving tier
on the card (serve/cli.py). Training, the default of the JAX package's
entry point, is not ported yet."""

import sys


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "serve":
        from distributedpytorch_tpu_torch.serve.cli import main as serve_main

        return serve_main(argv[1:])
    raise SystemExit(
        "training is not ported yet — the PyTorch port serves only: "
        "python -m distributedpytorch_tpu_torch serve -c <checkpoint.pth>"
    )


if __name__ == "__main__":
    sys.exit(main())
