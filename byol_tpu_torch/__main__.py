"""``python -m byol_tpu_torch serve ...`` — the port's entry point.

Only the ``serve`` subcommand exists in this slice; training comes later
(ROADMAP.md).
"""
import sys


def main() -> int:
    argv = sys.argv[1:]
    if argv and argv[0] == "serve":
        from byol_tpu_torch.serving.cli import main as serve_main
        return serve_main(argv[1:])
    print("usage: python -m byol_tpu_torch serve [flags]  (training is not "
          "ported yet; see ROADMAP.md)", file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
