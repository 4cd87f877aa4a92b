"""The benchmark package: runners that drive the port's servers and
pipeline over tasks and summarise RTF and latency (`harness`), quality
metrics (`metrics`) and the dispatch probe (`relay_probe`)."""
