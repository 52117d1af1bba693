"""``python -m distributedpytorch_tpu_torch [-t singleGPU] ...`` trains on
the card (cli.py), as the JAX package's entry point does;
``python -m distributedpytorch_tpu_torch serve ...`` serves
(serve/cli.py)."""

import sys


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "serve":
        from distributedpytorch_tpu_torch.serve.cli import main as serve_main

        return serve_main(argv[1:])
    from distributedpytorch_tpu_torch.cli import main as train_main

    return train_main(argv)


if __name__ == "__main__":
    sys.exit(main())
