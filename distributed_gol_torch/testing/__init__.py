"""Test-support harnesses that ship with the package.

Unlike ``tests/`` (repo-only), this subpackage is importable by users:
chaos drills against a production deployment need the same deterministic
fault injection the repo's own chaos matrix uses (``testing.faults``).
"""
