"""Forest learners of the port: the host (scikit-learn) fit and forest files."""
