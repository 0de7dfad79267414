"""Traffic drivers: the code that a traffic mix (traffic/<mix>.json) names
by its `driver` key; each runs a cell's set-up, window and comparison."""
