"""The harness's own machinery: names to files, seeds, weights, the
yardstick's arithmetic, the trace's reduction and the result line."""
