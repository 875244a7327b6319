"""Test-only machinery (the deterministic concurrency explorer and the
models it runs).

Nothing in paddle_tpu_torch's production import graph imports this
package; the sync layer (core/sync.py) reaches it only indirectly,
through a scheduler the HARNESS installs first.
"""
