"""``python -m byol_tpu_torch [serve|report|capture] ...``: train by
default, serve or render a run log's report as a subcommand (as ``python
-m byol_tpu``), or capture a trace of a live run started with
``--profile-port`` (as JAX's ``python -m jax.collect_profile``)."""
import sys


def main() -> int:
    argv = sys.argv[1:]
    if argv and argv[0] == "serve":
        from byol_tpu_torch.serving.cli import main as serve_main
        return serve_main(argv[1:])
    if argv and argv[0] == "report":
        from byol_tpu_torch.observability.report import main as report_main
        return report_main(argv[1:])
    if argv and argv[0] == "capture":
        from byol_tpu_torch.observability.capture import main as capture_main
        return capture_main(argv[1:])
    from byol_tpu_torch.cli import main as train_main
    return train_main(argv)


if __name__ == "__main__":
    raise SystemExit(main())
