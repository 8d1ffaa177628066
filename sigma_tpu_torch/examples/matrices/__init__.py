"""Matrix examples: the transition matrix and the operator algebra."""
