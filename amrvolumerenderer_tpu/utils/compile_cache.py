"""Persistent XLA compilation cache for the one-process-per-render surface.

The product's primary surface is a CLI launched once per job — exactly like
the reference binary (VolumeRenderer/main.cpp:19-36, run
under ``mpirun`` per render).  The reference pays no per-launch compile
because its kernels are AOT-compiled C++/CUDA; a JAX process instead traces
and compiles per shape.  JAX's on-disk executable cache turns every repeat
launch at a seen (shape, knob) configuration into a disk hit, restoring the
reference's "binary starts fast" property without giving up JIT.

Resolution, first match wins:

* **``JAX_COMPILATION_CACHE_DIR`` / a configured cache dir.**  If
  ``jax_compilation_cache_dir`` is already set, that directory is used and
  nothing is set in code.
* **``AVR_COMPILE_CACHE``.**  ``off``/``0``/``none``/``false`` disables; a
  path opts in on any backend.
* **GPU default.**  On the GPU the cache is on at a fixed path inside the
  checkout, ``<repo>/.jax_cache`` (listed in ``.gitignore``): the path is
  part of the cache key, so it never depends on the home directory, a temp
  name, a pid or a time.
* **CPU is opt-in.**  XLA:CPU serializes executables as AOT machine code
  keyed to the *build* host's CPU features; a shared directory could serve
  code with unsupported instructions on another host (SIGILL).  Explicit
  CPU requests therefore live under ``<dir>/cpu-<fingerprint>``, where the
  fingerprint hashes the host's CPU feature flags.

The unit suite sets ``AVR_COMPILE_CACHE=off`` in ``tests/conftest.py``;
only subprocess product tests that point the env var at a tmp dir ever
write cache entries.  Enabled on every product entry (driver CLI,
``render()``, ``api.render``).
"""

from __future__ import annotations

import os

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_GPU_DIR = os.path.join(_REPO_ROOT, ".jax_cache")
_configured: str | None = None
_attempted = False


def _machine_fingerprint() -> str:
    """Stable per-host id derived from the CPU's feature flags.

    XLA:CPU AOT executables embed machine-specific code paths (AVX-512/AMX
    etc.); hashing the ``flags`` line of /proc/cpuinfo (plus the arch name)
    keys the cache so an executable compiled on one host is never loaded on
    a host with different features.
    """
    import hashlib
    import platform

    desc = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    desc += line
                    break
    except OSError:
        pass
    return hashlib.sha1(desc.encode()).hexdigest()[:12]


def enable_persistent_compile_cache(cache_dir: str | None = None):
    """Point JAX's compilation cache at a durable directory (idempotent).

    Resolution order (see the module docstring): a cache dir JAX already
    has (``JAX_COMPILATION_CACHE_DIR``) is kept as is; an explicit
    ``cache_dir`` argument wins next (it bypasses the env kill-switch);
    then ``AVR_COMPILE_CACHE``; then ``DEFAULT_GPU_DIR`` on the GPU only.
    Returns the directory in use, or None when disabled/unavailable.
    Never raises: an unwritable directory leaves caching off.
    """
    global _configured, _attempted
    if _attempted:
        return _configured
    _attempted = True

    import jax

    existing = jax.config.jax_compilation_cache_dir
    if existing:
        _configured = existing
        return existing
    env = os.environ.get("AVR_COMPILE_CACHE", "")
    if cache_dir is None and env.lower() in ("off", "0", "none", "false"):
        return None
    target = cache_dir if cache_dir is not None else (env or None)
    backend = jax.default_backend()
    if target is None:
        if backend != "gpu":
            return None
        target = DEFAULT_GPU_DIR
    if backend == "cpu":
        target = os.path.join(target, "cpu-" + _machine_fingerprint())
    try:
        os.makedirs(target, exist_ok=True)
    except OSError:
        return None
    jax.config.update("jax_compilation_cache_dir", target)
    _configured = target
    return target
