"""The run's last lines: every number compared beside its limit on
standard error, then the result as one JSON line on standard output.
Before either, the process must hold no module of JAX or of the JAX
package: top-level module names are compared whole (the system under
test, ``byol_tpu_torch``, begins with the JAX package's name)."""
from __future__ import annotations

import json
import sys
from typing import Any, Dict, List

FORBIDDEN = ("jax", "jaxlib", "flax", "byol_tpu")


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def emit(result: Dict[str, Any], compared: Dict[str, Dict[str, float]]
         ) -> int:
    """Prints the result, or refuses to: returns the exit code."""
    loaded = forbidden_modules()
    if loaded:
        print(f"benchmark: the process holds {', '.join(loaded[:20])}: a "
              "run may load no module of jax, jaxlib, flax or byol_tpu; "
              "no result", file=sys.stderr, flush=True)
        return 3
    print("benchmark: imports: no module of jax, jaxlib, flax or byol_tpu "
          "is loaded", file=sys.stderr)
    for name, c in compared.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    line = dict(result)
    line["compared"] = compared
    print(json.dumps(line), flush=True)
    return 0
