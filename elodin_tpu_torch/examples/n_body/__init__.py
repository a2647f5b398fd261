"""N-body gravity (counterpart of ``examples/n-body``): ``main`` folds a
complete digraph (``GraphQuery[TotalEdge]``) over a dozen bodies;
``batched.run`` steps thousands of bodies on the all-pairs kernel."""
