"""Model code for the serving path: primitives, attention, the dense
transformer's parameters, and the architecture registry."""
