"""Plain versions, int8 evaluator, dispatch and validation of the MX ops."""
