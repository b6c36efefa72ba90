"""Louvain community detection: the port's own, step for step networkx's.

A transliteration of networkx 3.x ``louvain_communities`` and
``louvain_partitions`` (``networkx/algorithms/community/louvain.py``)
with ``modularity`` (``.../community/quality.py``) for undirected
weighted graphs, on plain adjacency dicts and the stdlib ``random``.
Every dict and set is built and walked in the order networkx builds and
walks its own, so the same seed gives the same partition, set for set,
and the same floats in every modularity sum.  The machine with the card
has no networkx; the CPU tests hold this module equal to it.
"""

from __future__ import annotations

import random
import typing
from collections import defaultdict


class Graph:
    """An undirected weighted graph as networkx's ``Graph`` stores one: a
    dict of nodes (in insertion order) to attribute dicts, and a dict of
    adjacency dicts (neighbours in insertion order) to one weight each.

    ``Graph(edges)`` takes ``(u, v, {"weight": w})`` triples (and ``(u,
    v)`` pairs, weight 1) and inserts nodes in the order they first
    appear, as ``networkx.Graph(edges)`` does.
    """

    def __init__(self, edges: typing.Iterable = ()):
        self.nodes: dict = {}
        self.adj: dict = {}
        for e in edges:
            if len(e) == 3:
                u, v, data = e
                self.add_edge(u, v, data.get("weight", 1))
            else:
                u, v = e
                self.add_edge(u, v, 1)

    def __len__(self) -> int:
        return len(self.nodes)

    def add_node(self, n, **attr) -> None:
        if n not in self.nodes:
            self.adj[n] = {}
            self.nodes[n] = attr
        else:
            self.nodes[n].update(attr)

    def add_edge(self, u, v, weight) -> None:
        """Set the weight of edge (u, v); an existing edge keeps its place
        in both adjacency dicts."""
        for n in (u, v):
            if n not in self.nodes:
                self.adj[n] = {}
                self.nodes[n] = {}
        self.adj[u][v] = weight
        self.adj[v][u] = weight

    def edges(self, nbunch=None):
        """(u, v, weight) of each edge once, in networkx's
        ``EdgeDataView`` order: nodes in order (or ``nbunch``'s order),
        each node's neighbours in order, an edge yielded from the first
        of its ends that the walk reaches."""
        seen = set()
        for n in (self.adj if nbunch is None else (n for n in nbunch if n in self.adj)):
            for nbr, w in self.adj[n].items():
                if nbr not in seen:
                    yield n, nbr, w
            seen.add(n)

    def degree(self, n):
        """Weighted degree, a self-loop counted twice (``DegreeView``)."""
        nbrs = self.adj[n]
        return sum(nbrs.values()) + (n in nbrs and nbrs[n])

    def size(self) -> float:
        return sum(self.degree(n) for n in self.nodes) / 2


def modularity(G: Graph, communities, resolution: float = 1) -> float:
    """networkx's ``modularity`` of an undirected weighted graph (no
    partition check)."""
    out_degree = {n: G.degree(n) for n in G.nodes}
    deg_sum = sum(out_degree.values())
    m = deg_sum / 2
    norm = 1 / deg_sum**2

    def community_contribution(community):
        comm = set(community)
        L_c = sum(wt for u, v, wt in G.edges(comm) if v in comm)
        out_degree_sum = sum(out_degree[u] for u in comm)
        in_degree_sum = out_degree_sum
        return L_c / m - resolution * out_degree_sum * in_degree_sum * norm

    return sum(map(community_contribution, list(communities)))


def _neighbor_weights(nbrs, node2com):
    weights = defaultdict(float)
    for nbr, wt in nbrs.items():
        weights[node2com[nbr]] += wt
    return weights


def _one_level(G: Graph, m, partition, resolution, seed: random.Random):
    """One level of the Louvain partitions tree (networkx ``_one_level``,
    undirected)."""
    node2com = {u: i for i, u in enumerate(G.nodes)}
    inner_partition = [{u} for u in G.nodes]
    degrees = {n: G.degree(n) for n in G.nodes}
    Stot = list(degrees.values())
    nbrs = {u: {v: w for v, w in G.adj[u].items() if v != u} for u in G.nodes}
    rand_nodes = list(G.nodes)
    seed.shuffle(rand_nodes)
    nb_moves = 1
    improvement = False
    while nb_moves > 0:
        nb_moves = 0
        for u in rand_nodes:
            best_mod = 0
            best_com = node2com[u]
            weights2com = _neighbor_weights(nbrs[u], node2com)
            degree = degrees[u]
            Stot[best_com] -= degree
            # (reading weights2com[best_com] inserts the key, as in networkx)
            remove_cost = -weights2com[best_com] / m + resolution * (
                Stot[best_com] * degree
            ) / (2 * m**2)
            for nbr_com, wt in weights2com.items():
                gain = (
                    remove_cost
                    + wt / m
                    - resolution * (Stot[nbr_com] * degree) / (2 * m**2)
                )
                if gain > best_mod:
                    best_mod = gain
                    best_com = nbr_com
            Stot[best_com] += degree
            if best_com != node2com[u]:
                com = G.nodes[u].get("nodes", {u})
                partition[node2com[u]].difference_update(com)
                inner_partition[node2com[u]].remove(u)
                partition[best_com].update(com)
                inner_partition[best_com].add(u)
                improvement = True
                nb_moves += 1
                node2com[u] = best_com
    partition = list(filter(len, partition))
    inner_partition = list(filter(len, inner_partition))
    return partition, inner_partition, improvement


def _gen_graph(G: Graph, partition) -> Graph:
    """The graph of the communities (networkx ``_gen_graph``)."""
    H = Graph()
    node2com = {}
    for i, part in enumerate(partition):
        nodes = set()
        for node in part:
            node2com[node] = i
            nodes.update(G.nodes[node].get("nodes", {node}))
        H.add_node(i, nodes=nodes)
    for node1, node2, wt in G.edges():
        com1 = node2com[node1]
        com2 = node2com[node2]
        temp = H.adj[com1].get(com2, 0)
        H.add_edge(com1, com2, wt + temp)
    return H


def louvain_partitions(G: Graph, resolution: float = 1, threshold: float = 1e-7,
                       seed=None):
    """Yield the partition of each level (networkx ``louvain_partitions``
    on an undirected graph that is not a multigraph)."""
    if not isinstance(seed, random.Random):
        seed = random.Random(seed)
    partition = [{u} for u in G.nodes]
    if not any(G.adj[n] for n in G.nodes):  # nx.is_empty: no edges
        yield partition
        return
    mod = modularity(G, partition, resolution=resolution)
    graph = Graph()
    for n in G.nodes:
        graph.add_node(n)
    for u, v, w in G.edges():
        graph.add_edge(u, v, w)
    m = graph.size()
    partition, inner_partition, improvement = _one_level(
        graph, m, partition, resolution, seed
    )
    improvement = True
    while improvement:
        yield [s.copy() for s in partition]
        new_mod = modularity(graph, inner_partition, resolution=resolution)
        if new_mod - mod <= threshold:
            return
        mod = new_mod
        graph = _gen_graph(graph, inner_partition)
        partition, inner_partition, improvement = _one_level(
            graph, m, partition, resolution, seed
        )


def louvain_communities(G: Graph, resolution: float = 1, threshold: float = 1e-7,
                        seed=None) -> typing.List[set]:
    """The last level's partition: a list of sets of nodes (networkx
    ``louvain_communities`` with ``weight="weight"``)."""
    final = None
    for final in louvain_partitions(G, resolution, threshold, seed):
        pass
    return final
