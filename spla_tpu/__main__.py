"""Package banner + environment report (reference analog:
``python/pyspla/__main__.py`` prints the project banner; here the
accelerator line doubles as a quick backend diagnostic).

Run as ``python -m spla_tpu``.
"""

from __future__ import annotations


def main() -> None:
    print("****** spla_tpu ******")
    print("Generalized sparse linear algebra on JAX/XLA.")
    print("Import `spla_tpu` as a module in your python scripts; "
          "CLI benchmarks live in `examples/`.")
    try:
        from .library import get_library

        print(get_library().get_accelerator_info())
    except Exception as e:  # pragma: no cover - backend/transport dependent
        print(f"(accelerator probe failed: {e})")


if __name__ == "__main__":
    main()
