"""ref: python/paddle/dataset/movielens.py — MovieLens-1M recsys loaders.
train()/test() yield [user_id, gender, age, job, movie_id, categories,
title, rating]; plus the id-space helpers models size embeddings with."""
from __future__ import annotations

import numpy as np

age_table = [1, 18, 25, 35, 45, 50, 56]

_N_MOVIES = 200
_N_USERS = 120
_N_JOBS = 21
_CATEGORIES = [
    "Action", "Adventure", "Animation", "Children's", "Comedy", "Crime",
    "Documentary", "Drama", "Fantasy", "Film-Noir", "Horror", "Musical",
    "Mystery", "Romance", "Sci-Fi", "Thriller", "War", "Western",
]


class MovieInfo:
    def __init__(self, index, categories, title):
        self.index = int(index)
        self.categories = categories
        self.title = title

    def value(self):
        return [self.index, [_CATEGORIES.index(c) for c in self.categories],
                [ord(ch) % 256 for ch in self.title]]

    def __repr__(self):
        return f"<MovieInfo id({self.index}), title({self.title})>"


class UserInfo:
    def __init__(self, index, gender, age, job_id):
        self.index = int(index)
        self.is_male = gender == "M"
        self.age = age_table.index(int(age))
        self.job_id = int(job_id)

    def value(self):
        return [self.index, 0 if self.is_male else 1, self.age, self.job_id]

    def __repr__(self):
        return (f"<UserInfo id({self.index}), gender("
                f"{'M' if self.is_male else 'F'}), age({age_table[self.age]}"
                f"), job({self.job_id})>")


def _movies():
    rng = np.random.RandomState(5)
    out = {}
    for i in range(1, _N_MOVIES + 1):
        cats = [_CATEGORIES[j] for j in
                rng.choice(len(_CATEGORIES), rng.randint(1, 4),
                           replace=False)]
        out[i] = MovieInfo(i, cats, f"Movie {i}")
    return out


def _users():
    rng = np.random.RandomState(6)
    out = {}
    for i in range(1, _N_USERS + 1):
        out[i] = UserInfo(i, "M" if rng.rand() < 0.5 else "F",
                          age_table[rng.randint(len(age_table))],
                          rng.randint(_N_JOBS))
    return out


_MOVIE_INFO = None
_USER_INFO = None


def movie_info():
    global _MOVIE_INFO
    if _MOVIE_INFO is None:
        _MOVIE_INFO = _movies()
    return _MOVIE_INFO


def user_info():
    global _USER_INFO
    if _USER_INFO is None:
        _USER_INFO = _users()
    return _USER_INFO


def get_movie_title_dict():
    words = sorted({w for m in movie_info().values()
                    for w in m.title.split()})
    return {w: i for i, w in enumerate(words)}


def max_movie_id():
    return max(movie_info())


def max_user_id():
    return max(user_info())


def max_job_id():
    return _N_JOBS - 1


def movie_categories():
    return {c: i for i, c in enumerate(_CATEGORIES)}


def _ratings(seed, n):
    rng = np.random.RandomState(seed)
    movies, users = movie_info(), user_info()
    for _ in range(n):
        u = users[rng.randint(1, _N_USERS + 1)]
        m = movies[rng.randint(1, _N_MOVIES + 1)]
        # preference structure: users like movies whose id parity matches
        base = 4.0 if (u.index + m.index) % 2 == 0 else 2.0
        rating = float(np.clip(base + rng.randn() * 0.7, 1, 5))
        yield u.value() + m.value() + [[rating]]


def train():
    def reader():
        yield from _ratings(7, 800)
    return reader


def test():
    def reader():
        yield from _ratings(8, 200)
    return reader
