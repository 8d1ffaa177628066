"""The example scripts of the port, module for module those of the JAX
package's ``examples/`` tree: the same problems from the same numpy seeds,
the same printed lines, on the card unless asked for another device.

    python -m sigma_tpu_torch.examples.solvers.solver_example_6 [--device cpu]

Each module's ``main(device=None, ...)`` prints its lines and returns
every printed number in a dict under a stable key.  ``EXAMPLES`` names
the modules in the order the port was written: graphs, matrices, the
solvers, the FEM and eigen recipes, then the structured and pruned
multigrid paths.
"""

EXAMPLES = (
    "graphs.graph_example_1",
    "graphs.graph_example_2",
    "graphs.graph_example_3",
    "graphs.graph_example_4",
    "matrices.matrix_example_1",
    "matrices.matrix_example_2",
    "solvers.solver_example_1",
    "fem_poisson",
    "eigen_example",
    "solvers.solver_example_2",
    "solvers.solver_example_3",
    "solvers.solver_example_4",
    "solvers.solver_example_5",
    "solvers.solver_example_6",
)
