"""Operations and bytes from shapes, one module per kernel or model part.
They count what the algorithm needs for a call, whatever implements it."""
