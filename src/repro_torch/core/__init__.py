"""Host substrate: heterogeneity profiles, scheduling, power, itemsets."""
