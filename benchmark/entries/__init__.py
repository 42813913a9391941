"""The session entries, one module a traffic mix's ``entry`` names; the
contract each keeps is in ``benchmark/spec.py``."""
