"""Printed classifiers: the MLP and the linear SVM the search trains."""
