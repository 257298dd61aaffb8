"""Runtime witnesses of the serving path (the port's part of the JAX
package's ``analysis/``): ``leakcheck`` (``DLLAMA_LEAKCHECK=1``, resources
still held at a drain point) and ``jitcheck`` (``DLLAMA_JITCHECK=1``, decode
graphs captured after warmup, the port's form of the JAX package's
post-warmup compiles). Both count always and raise only when enabled.

The JAX package's static analysis (``core.py``, ``cli.py``, the
``*_check.py`` modules, ``lockgraph.py``: a lint over Python source) is not
part of the serving path and is not ported yet.
"""

from . import jitcheck, leakcheck

__all__ = ["jitcheck", "leakcheck"]
