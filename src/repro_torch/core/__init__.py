"""Algorithm-1 math on tensors: statistics, predictors, models, epsilon
policies and the closed-form solver (port of ``repro.core``)."""
