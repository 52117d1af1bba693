"""``python -m distributedpytorch_tpu_torch [-t singleGPU] ...`` trains on
the card (cli.py), as the JAX package's entry point does;
``python -m distributedpytorch_tpu_torch serve ...`` serves
(serve/cli.py), ``predict ...`` writes masks for a directory of images
(predict.py), ``quantize ...`` converts a checkpoint to int8 weights
(quantize.py) and ``probe ...`` builds, launches and checks every kernel
on the card and writes the priors file (ops/probes.py)."""

import sys


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "serve":
        from distributedpytorch_tpu_torch.serve.cli import main as serve_main

        return serve_main(argv[1:])
    if argv and argv[0] == "predict":
        from distributedpytorch_tpu_torch.predict import main as predict_main

        return predict_main(argv[1:])
    if argv and argv[0] == "quantize":
        from distributedpytorch_tpu_torch.quantize import main as quant_main

        return quant_main(argv[1:])
    if argv and argv[0] == "probe":
        from distributedpytorch_tpu_torch.ops.probes import main as probe_main

        return probe_main(argv[1:])
    from distributedpytorch_tpu_torch.cli import main as train_main

    return train_main(argv)


if __name__ == "__main__":
    sys.exit(main())
