"""Graph frontend: nodes, ops, gradients, executor."""
