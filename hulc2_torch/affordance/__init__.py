"""The affordance model of the hierarchy: detector, labels, dataset and training."""
