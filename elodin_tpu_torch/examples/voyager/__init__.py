"""The Voyager-style trajectory with a Jupiter gravity assist (counterpart of
``examples/voyager``): ``main.build`` and ``main.specific_energy``."""
