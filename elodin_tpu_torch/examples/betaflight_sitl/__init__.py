"""The SITL lockstep example (counterpart of ``examples/betaflight-sitl``):
``main.run`` closes a 1 kHz hover loop with the ``controller.py`` process
over UDP, ``main.run_batched`` with a held command over a batched
lockstep session."""
