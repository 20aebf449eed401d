"""The methods the paper compares LargeVis with: LINE (``line``), exact
t-SNE and symmetric SNE (``tsne``), NN-Descent (``nn_descent``) and the
vantage-point tree (``vptree``, on the host)."""
