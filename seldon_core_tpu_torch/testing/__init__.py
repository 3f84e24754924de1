"""Contract tester and load generator of the port."""
