"""Analysis tools of the port (counterpart of ``repro/analysis``).

Only the lock-order recorder is ported so far (:mod:`.locks`); its
findings view and the offline log check need the reference's
``Finding`` type and come with the rest of the package.
"""
