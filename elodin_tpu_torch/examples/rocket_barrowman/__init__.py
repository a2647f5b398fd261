"""The Calisto-style rocket on Barrowman aerodynamics (counterpart of
``examples/rocket-barrowman``): ``barrowman`` (the equations) and ``main``
(the weathercocking six-dof)."""
